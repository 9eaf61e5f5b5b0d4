"""stage_tables_s: host seconds of the program's ``plan.tables`` spans in
set-up, summed over the staged studies' plans: each bucket's decode
tables and host operands (``build_lane_tables``, the alias and packed
table functions), from the program's own tracer
(``portbench/programtrace.py``)."""

from portbench.programtrace import span_seconds


def read(ctx):
    p = ctx.get("program")
    return span_seconds(p["setup_spans"], "plan.tables") if p else None
