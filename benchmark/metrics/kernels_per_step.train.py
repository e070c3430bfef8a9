"""Device kernels a train step in the profiled stretch."""
from benchmark import readers


def read(r):
    return readers.kernels_per_unit(r)
