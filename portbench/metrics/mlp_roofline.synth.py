"""The ConvNeXt MLPs' share of their roofline: the least time of the traced forwards' MLPs
(``counts.mlp_bound_s`` at their items' own frames: FLOPs or bytes, whichever binds, at the card's peaks)
over the device time launched inside the port's ``gen.mlp`` spans (pwconv1 -> GELU -> pwconv2 of every
block)."""

from portbench import reduce, spans


def read(run):
    bound_fn = getattr(run.counts, "mlp_bound_s", None)
    peak = reduce.peak_flops(run)
    if run.trace is None or bound_fn is None or peak is None or not run.traced_forwards:
        return None
    spent = spans.device_s_under(run.trace, spans.named("gen.mlp"))
    if not spent:
        return None
    bound = sum(bound_fn(run.cfg, sum(frames), peak, run.peaks["bytes_per_s"]) for frames in run.traced_forwards)
    return 100.0 * bound / spent
