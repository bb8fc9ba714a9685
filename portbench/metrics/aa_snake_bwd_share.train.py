"""The aa-snake backward's share of the traced device time: the device time of the operations launched
inside the port's ``aa_snake_backward`` ranges (``ops/aa_snake.py::AASnakeFunction.backward``) over the union of
all device operations."""

RANGE = "aa_snake_backward"


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    spent = run.trace.device_s_under(RANGE)
    return 100.0 * spent / run.trace.busy_s() if spent else None
