"""Device kernels an image in the profiled stretch."""
from benchmark import readers


def read(r):
    return readers.kernels_per_unit(r)
