"""Share of the profiled stretch the device is idle while the host is in
the clip or the LAMB step."""
from benchmark import spans


def read(r):
    return spans.idle_pct(r, "optimizer_idle_pct.train", spans.STEP, spans.OPTIMIZER)
