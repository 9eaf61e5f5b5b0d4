"""request_roofline: the least time the card could serve the traced
requests in (every compressed container read once, every pixel written
once, at the card's published memory bandwidth) as a share of the
device's busy time over them, in %."""

from portbench import roofline


def read(ctx):
    t, card = ctx.get("trace"), ctx.get("card")
    if not t or not card or t["busy_s"] <= 0:
        return None
    return roofline.share_pct(roofline.least_seconds(t["request_bytes"], card), t["busy_s"])
