"""The iSTFT head's device time per second of audio: device ms launched inside the port's ``gen.head`` span
(the projection, the exp and clip, cos and sin, the inverse FFT, the overlap-add and the envelope) over the
audio seconds of the traced forwards (their items' own frames x hop / sample rate)."""

from portbench import spans


def read(run):
    return spans.device_ms_per_audio_s(run, spans.named("gen.head"))
