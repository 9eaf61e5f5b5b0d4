"""run_host_ms: host milliseconds a request of the program's ``plan.run``
span (``MicwDecodePlan.run()``: its Python and its launches, no
synchronise) over the program-traced stretch, from the program's own
tracer (``portbench/programtrace.py``)."""

from portbench.programtrace import span_seconds


def read(ctx):
    p = ctx.get("program")
    if not p or not p["stretch"]["requests"]:
        return None
    return 1e3 * span_seconds(p["stretch"]["spans"], "plan.run") / p["stretch"]["requests"]
