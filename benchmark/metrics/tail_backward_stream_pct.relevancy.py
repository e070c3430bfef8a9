"""Share of the general gradcam tail's stream time (``sa.relevancy.tail``)
in its batched backward (``sa.relevancy.tail.backward``). None where the
program opens no such span (the closed form, or a program before it)."""
from benchmark import spans

TAIL = spans.TAIL[0]
BACKWARD = TAIL + ".backward"


def read(r):
    u = spans.units(r, TAIL)
    if u is None or not any(x.name == BACKWARD for x in u.leaves):
        return None
    return spans.stream_pct(r, "tail_backward_stream_pct.relevancy", TAIL, (BACKWARD,))
