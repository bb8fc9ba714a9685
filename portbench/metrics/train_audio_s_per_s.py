"""Seconds of audio trained on (batch x samples a step x completed steps) over the wall time from the
window's start to the ``synchronize`` after its last step."""


def read(run):
    return run.audio_s / run.window_s if run.window_s else None
