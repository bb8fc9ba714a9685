"""K2's share of its roofline: the least time of the traced forwards' AMP stages (``counts.k2_bound_s``:
ops or bytes, whichever binds, at the card's peaks) over the device time of the kernels whose name holds
``PATTERN`` (``csrc/amp_conv_mma.cu``)."""

from portbench import reduce

PATTERN = "amp_conv_mma"


def read(run):
    return reduce.roofline(run, PATTERN)
