"""K3's forward and backward bounds over a step's GroupNorm moments, over the
device time of the kernels that do them."""
from benchmark import readers


def read(r):
    return readers.roofline_pct(r, "channel_moments_roofline.train", "moments_bound_s_per_unit")
