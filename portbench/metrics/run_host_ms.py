"""run_host_ms: host milliseconds a request of the program's ``plan.run``
span (a staged plan's launches: its Python and its launch calls, no
synchronise) over the program-traced stretch, from the program's own
tracer (``portbench/programtrace.py``)."""

from portbench.programtrace import stretch_ms


def read(ctx):
    return stretch_ms(ctx, "plan.run")
