"""The AMP or MRF stages' device time per second of audio: device ms launched inside the port's
``gen.stage.{i}`` spans (K2's ``amp_stage`` in BigVGAN, the parallel resblocks in HiFiGAN) over the audio
seconds of the traced forwards (their items' own frames x hop / sample rate)."""

from portbench import spans


def read(run):
    return spans.device_ms_per_audio_s(run, spans.starting("gen.stage."))
