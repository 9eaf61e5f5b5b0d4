"""lanes_ms: device milliseconds a request of the scan-tier kernel
(``csrc/rans_lanes.cu``, both forms), from the trace."""

NAMES = ("lanes_groups_kernel", "lanes_wide_kernel")


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["requests"]:
        return None
    s = sum(v for name, v in t["by_name"].items() if any(n in name for n in NAMES))
    return 1e3 * s / t["requests"] if s > 0 else None
