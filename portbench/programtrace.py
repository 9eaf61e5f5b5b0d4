"""The program's own spans and counters, read beside the card's trace.

``mic_tpu_torch.trace`` records spans (a plan's staging and its parts, a
request's launches and answer, each kernel's call) on
``time.perf_counter_ns()`` with an anchor to ``time.time_ns()``.  A
``--trace 1`` run of the harness records them through set-up, then
serves a stretch with the program's tracing and the device trace both on
(:func:`serve_traced`, each request inside ``trace.request(i)``, under
``devtrace.profiled``, whose records lie on the wall clock), and reads
it here:

- :func:`program_stretch`, the stretch as the readers take it;
  :func:`host_spans`, the spans with the most self time;
  :func:`idle_by_span`, each idle gap of the card split over the innermost
  program span that covered each part of it; :func:`clock_violations`,
  port-kernel records that start before the ``run.*`` span that launched
  them (0 where the clocks agree);
- the readers of ``metrics/<name>.py`` that read ``ctx["program"]``
  (:func:`program_ctx`) and return None without it.

It imports nothing of JAX.  Where the program has no tracer, the harness
serves no such stretch and the readers find nothing to read.
"""

from __future__ import annotations

import bisect
import json

from . import roofline

HOST_SPANS = 10  # span names of the breakdown's host list
IDLE_SPANS = 10  # span names of the breakdown's idle list
SETUP_SPANS = 20  # span names of the set-up's line on standard error
OUTSIDE = "outside the program"
IN_CALLER = "request, in the caller"
# run() span -> the kernel names its launches leave in the trace
RUN_KERNELS = {"run.direct": ("direct_groups_kernel",), "run.rle": ("rle_groups_kernel",),
               "run.lanes": ("lanes_groups_kernel", "lanes_wide_kernel"),
               "run.post": ("post_groups_kernel",)}


def tracer():
    """The program's tracer, or None where the program has none."""
    try:
        from mic_tpu_torch import trace
    except ImportError:
        return None
    return trace


def serve_traced(served, trace, n: int, sample=None):
    """``n`` requests served by ``served.serve`` with the program's tracing
    on, each inside ``trace.request(i)``: (the stretch as ``Served.serve``
    returns it, (spans, counters) as ``trace.take()`` gives them, the
    anchor)."""
    trace.enable()
    try:
        out = served.serve(requests=n, sample=sample, spans=trace)
        return out, trace.take(), trace.anchor_ns()
    finally:
        trace.disable()


def program_stretch(served_traced, records, off) -> dict:
    """The stretch for the readers, from :func:`serve_traced`'s result and
    ``devtrace.profiled``'s records and clock error (none on the CPU): the
    stretch as ``Served.serve`` returns it, with its start and end on the
    wall clock (ns), the spans and counters, the anchor, the card's records
    and the clock's error."""
    out, (spans, counts), anchor = served_traced
    start_ns = anchor + min((s.start for s in spans if s.name == "request"), default=0)
    return {**out, "start_ns": start_ns, "end_ns": start_ns + round(1e9 * out["wall_s"]),
            "spans": spans, "counts": counts, "anchor_ns": anchor, "records": records,
            "clock_offset_ns": off}


def program_ctx(setup, stretch) -> dict | None:
    """``ctx["program"]`` for the readers: the set-up's spans and counters
    (``setup``, as ``trace.take()`` gives them) and the stretch."""
    if setup is None or stretch is None:
        return None
    spans, counts = setup
    return {"setup_spans": spans, "setup_counts": counts, "stretch": stretch}


def span_seconds(spans, name: str) -> float | None:
    """The seconds of every span named ``name``; None where there is none."""
    ns = [s.end - s.start for s in spans if s.name == name]
    return 1e-9 * sum(ns) if ns else None


def stretch_ms(ctx, name: str) -> float | None:
    """Host milliseconds a request of every span named ``name`` over the
    program-traced stretch; None without the program or such a span."""
    p = ctx.get("program")
    if not p or not p["stretch"]["requests"]:
        return None
    s = span_seconds(p["stretch"]["spans"], name)
    return None if s is None else 1e3 * s / p["stretch"]["requests"]


def kernel_roofline(ctx, kernel: str):
    """The least time the card could do ``kernel``'s work in over the
    program-traced stretch (the program's counter ``work_bytes.<kernel>``
    at the card's published memory bandwidth) as a share of the device
    seconds of the kernel's records in the same stretch, in %; None
    without the program, the card's peaks, the work or the records."""
    p, card = ctx.get("program"), ctx.get("card")
    if not p or not card:
        return None
    st = p["stretch"]
    work = st["counts"].get(f"work_bytes.{kernel}", 0)
    names = RUN_KERNELS[f"run.{kernel}"]
    busy = 1e-9 * sum(e - s for name, s, e in st["records"] if any(n in name for n in names))
    if not work or busy <= 0:
        return None
    return roofline.share_pct(roofline.least_seconds(work, card), busy)


def self_times(spans) -> dict[str, float]:
    """Seconds by span name of each span's own time: its duration less
    its children's."""
    child: dict[int, int] = {}
    for s in spans:
        if s.parent:
            child[s.parent] = child.get(s.parent, 0) + (s.end - s.start)
    out: dict[str, float] = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + 1e-9 * (s.end - s.start - child.get(s.id, 0))
    return out


def host_spans(spans, top: int = HOST_SPANS) -> list:
    """The ``top`` span names with the most self time, [name, seconds]."""
    return [[n, s] for n, s in sorted(self_times(spans).items(), key=lambda kv: -kv[1])[:top]]


def device_gaps(records, start_ns: int, end_ns: int) -> list[tuple[int, int]]:
    """The stretches of [start_ns, end_ns] in which no record ran on the
    card (records sorted by start, wall ns)."""
    gaps, at = [], start_ns
    for _name, s, e in records:
        if s > at:
            gaps.append((at, min(s, end_ns)))
        at = max(at, e)
    if end_ns > at:
        gaps.append((at, end_ns))
    return [(a, b) for a, b in gaps if b > a]


def _label(span) -> str:
    return IN_CALLER if span.name == "request" else span.name


def idle_by_span(gaps, spans, anchor_ns: int) -> dict[str, float]:
    """Seconds of the card's idle ``gaps`` (wall ns) by the innermost
    program span that covered each part of them (a span's time plus
    ``anchor_ns``): a request's own span is "request, in the caller", no
    span "outside the program"."""
    depth: dict[int, int] = {}
    by_id = {s.id: s for s in spans}

    def deep(s):
        if s.id not in depth:
            depth[s.id] = 1 + (deep(by_id[s.parent]) if s.parent in by_id else 0)
        return depth[s.id]

    iv = sorted(((s.start + anchor_ns, s.end + anchor_ns, deep(s), s) for s in spans),
                key=lambda v: v[0])
    starts = [v[0] for v in iv]
    longest = max((v[1] - v[0] for v in iv), default=0)
    out: dict[str, float] = {}
    for a, b in gaps:
        lo = bisect.bisect_left(starts, a - longest)
        hi = bisect.bisect_right(starts, b)
        near = [v for v in iv[lo:hi] if v[1] > a and v[0] < b]
        cuts = sorted({a, b, *(max(a, v[0]) for v in near), *(min(b, v[1]) for v in near)})
        for x, y in zip(cuts, cuts[1:]):
            cover = [v for v in near if v[0] <= x and v[1] >= y]
            name = _label(max(cover, key=lambda v: v[2])[3]) if cover else OUTSIDE
            out[name] = out.get(name, 0.0) + 1e-9 * (y - x)
    return out


def clock_violations(records, spans, anchor_ns: int) -> int:
    """Port-kernel records that start before the start of the ``run.*``
    span that launched them, the k-th launch of a kernel paired with the
    k-th record of its names (a span launches its ``launches``); a kernel
    whose records and launches differ in number counts the difference."""
    bad = 0
    for run, names in RUN_KERNELS.items():
        launches = []
        for s in sorted((s for s in spans if s.name == run), key=lambda s: s.start):
            launches += [s.start + anchor_ns] * int(s.attrs.get("launches", 0))
        starts = [r[1] for r in records if any(n in r[0] for n in names)]
        bad += abs(len(starts) - len(launches))
        bad += sum(1 for r, s in zip(starts, launches) if r < s)
    return bad


def breakdown(program: dict) -> dict:
    """The breakdown's two lists of the stretch: ``host_spans`` and
    ``idle_by_span`` ([name, seconds], most first)."""
    st = program["stretch"]
    gaps = device_gaps(st["records"], st["start_ns"], st["end_ns"])
    idle = idle_by_span(gaps, st["spans"], st["anchor_ns"]) if st["records"] else {}
    return {"host_spans": host_spans(st["spans"]),
            "idle_by_span": [[n, s] for n, s in sorted(idle.items(),
                                                       key=lambda kv: -kv[1])[:IDLE_SPANS]]}


def stretch_note(program: dict, dispatch: dict | None, profiled: dict | None = None) -> str:
    """One line on the stretch for standard error: its counters, the clock
    check and the host seconds in the program's calls against the untraced
    stretch's (``dispatch``) and the device-traced one's (``profiled``)."""
    st = program["stretch"]
    bad = clock_violations(st["records"], st["spans"], st["anchor_ns"])
    cost = ""
    if dispatch and dispatch["requests"]:
        cost = (f", in-call s {st['dispatch_s']:.6f} for {st['requests']} requests against "
                f"{dispatch['dispatch_s']:.6f} for {dispatch['requests']} untraced")
    if profiled and profiled["requests"]:
        cost += f" and {profiled['dispatch_s']:.6f} under the device trace alone"
    off = st["clock_offset_ns"]
    clock = f" (trace clock's error {off[0] / 1e3:.1f} / {off[1] / 1e3:.1f} us)" if off else ""
    return (f"portbench: program stretch: clock_violations {bad}{clock}, counters "
            f"{json.dumps(st['counts'], sort_keys=True)}{cost}")


def setup_note(program: dict) -> str:
    """One line on set-up for standard error: the spans with the most self
    time (the library's load, the encode, the plans' staging and its
    parts) and the counters (how the cell routes its strips)."""
    top = [[n, round(v, 6)] for n, v in host_spans(program["setup_spans"], top=SETUP_SPANS)]
    return (f"portbench: program set-up: spans {json.dumps(top)}, counters "
            f"{json.dumps(program['setup_counts'], sort_keys=True)}")
