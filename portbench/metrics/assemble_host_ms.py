"""assemble_host_ms: host milliseconds a request of the program's
``plan.assemble`` span (a plan's answer on the device: its gathers'
launches and its loop over the images) over the program-traced stretch,
from the program's own tracer (``portbench/programtrace.py``)."""

from portbench.programtrace import stretch_ms


def read(ctx):
    return stretch_ms(ctx, "plan.assemble")
