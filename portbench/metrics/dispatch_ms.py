"""dispatch_ms: host milliseconds a request inside the program's calls
(the request path's ``launch`` and ``answer``: on the ``micw`` path
``plan.run()`` and ``plan.assemble_device``), without a synchronise,
over an untraced stretch of the trace run."""


def read(ctx):
    d = ctx.get("dispatch")
    return 1e3 * d["dispatch_s"] / d["requests"] if d and d["requests"] else None
