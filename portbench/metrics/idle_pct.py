"""idle_pct: the share of the traced stretch's host wall time (first
submit to the closing synchronise) in which no operation ran on the
card, in %."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
