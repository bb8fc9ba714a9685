"""The ConvNeXt stages' device time outside their MLPs, per second of audio: device ms launched inside the
port's ``gen.stage.{i}`` spans less that inside their ``gen.mlp`` spans (the stem and transitions, the
depthwise convs, LayerNorms, masks, layer scales and residual adds), over the audio seconds of the traced
forwards (their items' own frames x hop / sample rate)."""

from portbench import spans


def read(run):
    stages = spans.device_ms_per_audio_s(run, spans.starting("gen.stage."))
    mlp = spans.device_ms_per_audio_s(run, spans.named("gen.mlp"))
    return None if stages is None or mlp is None else stages - mlp
