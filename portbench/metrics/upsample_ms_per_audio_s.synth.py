"""The upsamples' device time per second of audio: device ms launched inside the port's ``gen.up.{i}`` spans
(each stage's transposed conv, its mask, HiFiGAN's SiLU before it) over the audio seconds of the traced
forwards (their items' own frames x hop / sample rate)."""

from portbench import spans


def read(run):
    return spans.device_ms_per_audio_s(run, spans.starting("gen.up."))
