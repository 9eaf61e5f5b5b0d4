"""tans_ms: device milliseconds a request of the tANS kernel
(``csrc/tans_decode.cu``, ``tans_groups_kernel``), from the trace."""

NAMES = ("tans_groups_kernel",)


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["requests"]:
        return None
    s = sum(v for name, v in t["by_name"].items() if any(n in name for n in NAMES))
    return 1e3 * s / t["requests"] if s > 0 else None
