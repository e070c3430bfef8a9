"""Share of an image's stream time in the gradcam tail (``sa.relevancy.tail``)."""
from benchmark import spans


def read(r):
    return spans.stream_pct(r, "tail_stream_pct.relevancy", spans.IMAGE, spans.TAIL)
