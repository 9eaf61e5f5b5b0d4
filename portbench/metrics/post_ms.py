"""post_ms: device milliseconds a request of the post kernel
(``csrc/post.cu``, ``post_groups_kernel``, either instance), from the
trace."""

NAMES = ("post_groups_kernel",)


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["requests"]:
        return None
    s = sum(v for name, v in t["by_name"].items() if any(n in name for n in NAMES))
    return 1e3 * s / t["requests"] if s > 0 else None
