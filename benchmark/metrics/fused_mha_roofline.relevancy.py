"""K1's bound over the head scan's attention of an image, over the device
time of the kernels that do it."""
from benchmark import readers


def read(r):
    return readers.roofline_pct(r, "fused_mha_roofline.relevancy", "mha_bound_s_per_unit")
