"""tans_roofline: the tANS kernel's (``tans_groups_kernel``) share of its
roofline over the program-traced stretch: the program's counter
``work_bytes.tans`` (each stream's compressed bytes read once and 2 x its
symbols written once) at the card's published memory bandwidth, over the
device seconds of the kernel's records in the same stretch, in %.  It
reads the records itself: ``programtrace.kernel_roofline`` knows the
kernels of the MICW plan's ``run.*`` spans only."""

from portbench import roofline

NAMES = ("tans_groups_kernel",)


def read(ctx):
    p, card = ctx.get("program"), ctx.get("card")
    if not p or not card:
        return None
    st = p["stretch"]
    work = st["counts"].get("work_bytes.tans", 0)
    busy = 1e-9 * sum(e - s for name, s, e in st["records"] if any(n in name for n in NAMES))
    if not work or busy <= 0:
        return None
    return roofline.share_pct(roofline.least_seconds(work, card), busy)
