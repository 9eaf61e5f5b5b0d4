"""direct_roofline: the direct kernel's (``direct_groups_kernel``: the
direct buckets, and the post buckets' entropy stage) share of its
roofline over the program-traced stretch: the program's counter
``work_bytes.direct`` (each strip's MICT stream read once and its pixels,
or its symbols for the post kernel, written once) at the card's
published memory bandwidth, over the kernel's device seconds in the same
stretch, in %."""

from portbench.programtrace import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "direct")
