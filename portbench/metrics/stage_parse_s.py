"""stage_parse_s: host seconds of the program's ``plan.parse`` spans in
set-up, summed over the staged studies' plans: the containers' and their
MICT streams' parse and the strips' bucket keys (``micw_parse``,
``mict_parse``, ``_strip_bucket``), from the program's own tracer
(``portbench/programtrace.py``)."""

from portbench.programtrace import span_seconds


def read(ctx):
    p = ctx.get("program")
    return span_seconds(p["setup_spans"], "plan.parse") if p else None
