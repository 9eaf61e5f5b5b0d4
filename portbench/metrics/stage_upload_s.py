"""stage_upload_s: host seconds of the program's ``plan.upload`` spans in
set-up, summed over the staged studies' plans: the buckets' operands
copied to the card and the kernels' packings built and copied, from the
program's own tracer (``portbench/programtrace.py``)."""

from portbench.programtrace import span_seconds


def read(ctx):
    p = ctx.get("program")
    return span_seconds(p["setup_spans"], "plan.upload") if p else None
