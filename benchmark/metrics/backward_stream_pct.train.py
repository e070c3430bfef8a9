"""Share of a train step's stream time in its backward (``sa.train.backward``)."""
from benchmark import spans


def read(r):
    return spans.stream_pct(r, "backward_stream_pct.train", spans.STEP, spans.BACKWARD)
