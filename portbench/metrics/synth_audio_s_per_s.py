"""Seconds of audio returned to the host (each item's own length, not the padding) over the wall time from
the window's start to the return of its last group."""


def read(run):
    return run.audio_s / run.window_s if run.window_s else None
