"""Share of a train step's stream time in the clip and the LAMB step
(``sa.train.clip``, ``sa.train.optimizer``)."""
from benchmark import spans


def read(r):
    return spans.stream_pct(r, "optimizer_stream_pct.train", spans.STEP, spans.OPTIMIZER)
