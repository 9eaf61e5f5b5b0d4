"""assemble_ms: device milliseconds a request of every operation that is
not a port kernel: ``assemble_device``'s gathers and whatever torch
operations ``plan.run()`` adds, from the trace."""

from portbench.devtrace import is_port_kernel


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["requests"]:
        return None
    s = sum(v for name, v in t["by_name"].items() if not is_port_kernel(name, t["port"]))
    return 1e3 * s / t["requests"] if s > 0 else None
