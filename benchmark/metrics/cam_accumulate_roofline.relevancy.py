"""K2's bound over the tail's accumulation of an image (every tile through
every tail block), over the device time of the kernels that do it."""
from benchmark import readers


def read(r):
    return readers.roofline_pct(r, "cam_accumulate_roofline.relevancy", "cam_bound_s_per_unit")
