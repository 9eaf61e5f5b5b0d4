"""post_roofline: the post kernel's (``post_groups_kernel``) share of its
roofline over the program-traced stretch: the program's counter
``work_bytes.post`` (each strip's symbols read once and its pixels
written once) at the card's published memory bandwidth, over the
kernel's device seconds in the same stretch, in %."""

from portbench.programtrace import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "post")
