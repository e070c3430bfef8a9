"""Share of an image's stream time in the pipeline's stages: the spans
text, images, plan, tiles and canvas of ``sa.relevancy.image``."""
from benchmark import spans


def read(r):
    return spans.stream_pct(r, "prep_stream_pct.relevancy", spans.IMAGE, spans.PREP)
