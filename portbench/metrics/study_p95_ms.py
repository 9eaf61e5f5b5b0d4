"""study_p95_ms: the 95th percentile over every request of the window of
its latency: from its submit on the host's clock to the end of its
assemble on the card (a CUDA event after it, placed on the host's clock by
an event recorded at the window's start), queueing behind the requests in
flight and every gap included."""

import numpy as np


def read(ctx):
    w = ctx.get("window")
    return float(np.percentile(w["latency_ms"], 95)) if w and w["latency_ms"] else None
