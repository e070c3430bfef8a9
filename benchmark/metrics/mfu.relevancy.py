"""An image's FLOPs over its unprofiled seconds, as a share of the bf16 peak."""
from benchmark import readers


def read(r):
    return readers.mfu_pct(r)
