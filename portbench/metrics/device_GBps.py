"""device_GBps: u16 pixel bytes of the traced stretch's requests over the
seconds the card was busy in it (the union of its operations' intervals),
in GB/s: the card's own rate of decoding and assembling studies, which the
host's pace leaves alone."""


def read(ctx):
    t = ctx.get("trace")
    return t["pixel_bytes"] / t["busy_s"] / 1e9 if t and t["busy_s"] > 0 else None
