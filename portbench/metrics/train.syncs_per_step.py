"""Host-device synchronisations a training step: the runtime's ``cudaStreamSynchronize``,
``cudaDeviceSynchronize`` and ``cudaEventSynchronize`` calls that begin inside any of the port's
``train.*`` spans, over the traced steps.  Each drains the card's queue, which then waits for the host."""

from portbench import spans


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    count = spans.sync_calls(run.trace, spans.starting("train."))
    return None if count is None else count / run.traced_steps
