"""decode_GBps: u16 pixel bytes of every image of every request served in
the window over the window's seconds on the host's clock (from the first
submit to the closing synchronise), in GB/s (1e9 bytes): the rate at which
one serving process hands studies to its callers."""


def read(ctx):
    w = ctx.get("window")
    return w["pixel_bytes"] / w["wall_s"] / 1e9 if w and w["requests"] else None
