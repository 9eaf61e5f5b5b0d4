"""plan_stage_s: host seconds of building the staged studies'
``MicwDecodePlan`` objects (container parse, bucket keying, tables,
packings, copies to the card)."""


def read(ctx):
    return ctx["plan_stage_s"]
