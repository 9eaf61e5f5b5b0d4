"""assemble_host_ms: host milliseconds a request of the program's
``plan.assemble`` span (``assemble_device``: its gathers' launches and its
loop over the images) over the program-traced stretch, from the
program's own tracer (``portbench/programtrace.py``)."""

from portbench.programtrace import span_seconds


def read(ctx):
    p = ctx.get("program")
    if not p or not p["stretch"]["requests"]:
        return None
    return 1e3 * span_seconds(p["stretch"]["spans"], "plan.assemble") / p["stretch"]["requests"]
