"""Share of the unprofiled time of a train step the device is idle."""
from benchmark import readers


def read(r):
    return readers.idle_pct(r)
