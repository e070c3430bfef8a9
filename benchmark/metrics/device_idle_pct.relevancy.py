"""Share of the unprofiled time of an image the device is idle."""
from benchmark import readers


def read(r):
    return readers.idle_pct(r)
