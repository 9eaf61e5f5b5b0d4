"""plan_stage_s: host seconds of staging the studies' plans, the request
path's ``stage`` a study (on the ``micw`` path: container parse, bucket
keying, tables, packings, copies to the card)."""


def read(ctx):
    return ctx["plan_stage_s"]
