"""Share of the profiled stretch the device is idle while the host is in
one of the pipeline's stages (text, images, plan, tiles, canvas)."""
from benchmark import spans


def read(r):
    return spans.idle_pct(r, "prep_idle_pct.relevancy", spans.IMAGE, spans.PREP)
