"""The program's own spans and counters, read beside the card's trace.

``mic_tpu_torch.trace`` records spans (a plan's staging and its parts, a
request's ``run()`` and ``assemble_device``, each kernel's call) on
``time.perf_counter_ns()`` with an anchor to ``time.time_ns()``.  This
module serves a stretch of requests with the program's tracing and the
device trace both on, each request inside ``trace.request(i)``, and
reads it:

- :func:`profiled`: ``devtrace.profiled`` (its guards, its records) with
  marker launches on an idle card before and after the work, which put
  the card's records on the host's wall clock (ns): the trace's own clock
  for them is off by up to hundreds of microseconds in some profiler
  sessions and drifts within one (:func:`clock_offsets`,
  :func:`on_host_clock`);
- :func:`program_stretch`: the stretch, served by ``Served.serve`` itself;
  :func:`host_spans`, the spans with the most self time;
  :func:`idle_by_span`, each idle gap of the card split over the innermost
  program span that covered each part of it; :func:`clock_violations`,
  port-kernel records that start before the ``run.*`` span that launched
  them (0 where the clocks agree);
- the readers of :data:`NEW_METRICS` (``metrics/<name>.py``), which read
  ``ctx["program"]`` (:func:`program_ctx`) and return None without it;
- :func:`run_cell`: a ``--trace 1`` run of a cell by ``harness.run_cell``
  itself, with the program's tracing on through set-up and this stretch
  after the harness's two (``python3 -m portbench.programtrace --help``).

It imports nothing of JAX.  Where the program has no tracer, the stretch
and the readers find nothing to read and return None.
"""

from __future__ import annotations

import argparse
import bisect
import itertools
import json
import sys
import time

import numpy as np

from . import devtrace, harness, roofline

HOST_SPANS = 10  # span names of the breakdown's host list
OUTSIDE = "outside the program"
IN_CALLER = "request, in the caller"
# run() span -> the kernel names its launches leave in the trace
RUN_KERNELS = {"run.direct": ("direct_groups_kernel",), "run.rle": ("rle_groups_kernel",),
               "run.lanes": ("lanes_groups_kernel", "lanes_wide_kernel"),
               "run.post": ("post_groups_kernel",)}
MARKERS = 10  # marker launches before and after a traced stretch, for the clocks
NEW_METRICS = {"stage_parse_s": "s", "stage_tables_s": "s", "stage_upload_s": "s",
               "run_host_ms": "ms", "assemble_host_ms": "ms", "direct_roofline": "%",
               "rle_roofline": "%", "lanes_roofline": "%", "post_roofline": "%"}


def tracer():
    """The program's tracer, or None where the program has none."""
    try:
        from mic_tpu_torch import trace
    except ImportError:
        return None
    return trace


def _markers(x, n: int) -> list[tuple[int, int]]:
    """``n`` launches of a one-element kernel (``x.neg_()``), each on an
    idle card: the host's wall clock (ns) before and after each launch
    call."""
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize(x.device)
        t0 = time.time_ns()
        x.neg_()
        out.append((t0, time.time_ns()))
    torch.cuda.synchronize(x.device)
    return out


def clock_offsets(records, before, after):
    """The trace clock's error against the host's (ns) at the markers
    before and after the traced work, and the records without the
    markers.  A marker's kernel starts on an idle card while its launch
    call runs, so each marker puts the error at its record's start less
    the middle of its call (within half the call, ~7 us); the markers
    are the records named as the first one.  Raises ValueError where the
    trace does not hold one record a marker."""
    name = records[0][0] if records else None
    marks = [r for r in records if r[0] == name]
    if len(marks) != len(before) + len(after):
        raise ValueError(f"{len(marks)} marker records for {len(before) + len(after)} markers")
    err = [r[1] - (t0 + t1) // 2 for r, (t0, t1) in zip(marks, before + after)]
    k = len(before)
    at = (int(np.median([r[1] for r in marks[:k]])), int(np.median([r[1] for r in marks[k:]])))
    off = (float(np.median(err[:k])), float(np.median(err[k:])))
    return at, off, [r for r in records if r[0] != name]


def on_host_clock(records, at, off):
    """``records`` with the trace clock's error taken out: each moved by
    the error at its start, interpolated linearly between the two
    markers' (``clock_offsets``), so that its length stays the card's."""
    slope = (off[1] - off[0]) / (at[1] - at[0]) if at[1] != at[0] else 0.0
    out = []
    for name, s, e in records:
        d = round(off[0] + slope * (s - at[0]))
        out.append((name, s - d, e - d))
    return out


def profiled(fn, device):
    """``fn()`` under ``devtrace.profiled`` with :data:`MARKERS` marker
    launches on ``device`` before and after it: (result, records [(name,
    start ns, end ns)] on the host's wall clock sorted by start, without
    the markers; the trace clock's error (ns) left at the markers before
    and after once the records are placed by the markers before: about
    0, and the drift over the work).  The trace's clock for the card's
    records differs from the host's by an amount that changes between
    profiler sessions and drifts within one (up to 410 us on an H100
    machine), so each session measures it with the markers.  Raises ``devtrace.LostRecords`` where the trace does not
    hold one record a counted port launch."""
    import torch

    x = torch.zeros(1, device=device)

    def marked():
        first = _markers(x, MARKERS)
        out = fn()
        return first, out, _markers(x, MARKERS)

    (first, out, last), spans = devtrace.profiled(marked)
    raw = [(name, round(1e9 * s), round(1e9 * e)) for name, s, e in spans]
    # devtrace's seconds from the trace's start, on the wall clock as the
    # markers before the work put them (the first records: the card is
    # idle then), in whole ns; the markers measure what is left
    shifts = sorted((t0 + t1) // 2 - r[1] for r, (t0, t1) in zip(raw, first))
    shift = shifts[len(shifts) // 2] if shifts else 0
    at, off, records = clock_offsets([(n, s + shift, e + shift) for n, s, e in raw], first, last)
    return out, sorted(on_host_clock(records, at, off), key=lambda r: r[1]), off


class _Request:
    """A plan whose ``run()`` opens ``trace.request(i)``, i the next of
    ``ids``, and whose ``assemble_device`` closes it: ``Served.serve``
    serves it as the plan, each request inside its own span."""

    __slots__ = ("plan", "ids", "open")

    def __init__(self, plan, ids):
        self.plan, self.ids, self.open = plan, ids, None

    def run(self):
        self.open = tracer().request(next(self.ids))
        self.open.__enter__()
        try:
            return self.plan.run()
        except BaseException:
            self.open.__exit__(None, None, None)
            raise

    def assemble_device(self, outs):
        try:
            return self.plan.assemble_device(outs)
        finally:
            self.open.__exit__(None, None, None)


def program_stretch(served, n: int) -> dict | None:
    """``n`` requests served by ``served.serve`` (no sample taken), each
    inside ``trace.request(i)``, with the program's tracing on and, on
    the card, under :func:`profiled`: the stretch as ``Served.serve``
    returns it, with its start and end on the wall clock (ns), the spans
    and counters, the anchor, the card's records and the clock's error
    (none on the CPU).  None where the program has no tracer."""
    import torch

    trace = tracer()
    if trace is None:
        return None
    plans, ids = served.plans, itertools.count()

    def stretch():
        trace.enable()
        try:
            out = served.serve(requests=n)
            return out, trace.take(), trace.anchor_ns()
        finally:
            trace.disable()

    served.plans = [_Request(p, ids) for p in plans]
    try:
        if served.cuda and torch.cuda.is_available():
            (out, (spans, counts), anchor), records, off = profiled(stretch, served.device)
        else:
            (out, (spans, counts), anchor), records, off = stretch(), [], None
    finally:
        served.plans = plans
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


def span_seconds(spans, name: str) -> float:
    """The seconds of every span named ``name``."""
    return 1e-9 * sum(s.end - s.start for s in spans if s.name == name)


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
            "idle_by_span": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])]}


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


# -- a --trace 1 run with the program's spans, off the benchmark ---------------


class _Served(harness.Served):
    """``harness.Served`` for :func:`run_cell`: the program's tracing on
    from the start of set-up to the end of its warm-up (the first
    ``serve``), each ``serve``'s stretch kept (``stretches``: (requests,
    seconds, whether a sample was taken), result), and the program's
    stretch (:func:`program_stretch`) served when ``harness.run_cell``
    lets go of the plans, after its own two stretches and its metrics and
    before its comparison."""

    last = None  # the last one made

    def __init__(self, *args, **kwargs):
        trace = tracer()
        trace.take()
        trace.enable()
        try:
            super().__init__(*args, **kwargs)
        except BaseException:
            trace.disable()
            raise
        self.stretches, self.setup, self.program = [], None, None
        _Served.last = self

    def serve(self, *, seconds=None, requests=None, sample=None):
        out = super().serve(seconds=seconds, requests=requests, sample=sample)
        if self.setup is None:  # the warm-up, the end of set-up
            self.setup = tracer().take()
            tracer().disable()
        self.stretches.append(((requests, seconds, sample is not None), out))
        return out

    def __delattr__(self, name):
        if name == "plans" and self.program is None:
            self.program = harness._quiet(
                lambda: program_stretch(self, harness.TRACE_REQUESTS))
        super().__delattr__(name)


def run_cell(bench: dict, workload: str, seed: int, device, t_start: float, root=None) -> dict:
    """A ``--trace 1`` run of ``workload`` by ``harness.run_cell``, with the
    program's tracing on through set-up and a third stretch of
    ``harness.TRACE_REQUESTS`` requests traced both ways after the
    harness's two.  Returns the harness's result line with
    :data:`NEW_METRICS` among its metrics, ``host_spans`` and
    ``idle_by_span`` in its breakdown, the set-up's spans and counters
    and the stretch's notes; where the program has no tracer, the
    harness's line alone."""
    root = root or harness.ROOT
    if tracer() is None:
        return harness.run_cell(bench, workload, seed, 0.0, True, device, t_start, root)[0]
    made = harness.Served
    harness.Served = _Served
    try:
        result = harness.run_cell(bench, workload, seed, 0.0, True, device, t_start, root)[0]
    finally:
        harness.Served = made
    served, _Served.last = _Served.last, None
    program = program_ctx(served.setup, served.program)
    ctx = {"program": program, "card": roofline.peaks(result["device"]["kind"])}
    for name, unit in NEW_METRICS.items():
        value = harness.load_metric(name, root)(ctx)
        if value is not None:
            result["metrics"][name] = {"value": value, "unit": unit}
    result["breakdown"].update(breakdown(program))
    result["setup_spans"] = host_spans(program["setup_spans"], top=20)
    result["setup_counts"] = program["setup_counts"]
    st = program["stretch"]
    untraced, device_only = served.stretches[1][1], served.stretches[-2][1]
    result["stretch"] = {"requests": st["requests"], "wall_s": st["wall_s"],
                         "in_call_s": st["dispatch_s"], "counts": st["counts"],
                         "clock_offset_ns": st["clock_offset_ns"],
                         "clock_violations": clock_violations(st["records"], st["spans"],
                                                              st["anchor_ns"]),
                         "served": [shape for shape, _out in served.stretches],
                         "untraced_in_call_s": untraced["dispatch_s"],
                         "profiled_in_call_s": device_only["dispatch_s"]}
    print(stretch_note(program, untraced, device_only), file=sys.stderr)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="A --trace 1 run of one cell with the program's "
                                            "spans: one JSON line a seed.")
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json, or with "
                                                     "--config and --traffic a new name")
    p.add_argument("--config", help="with --traffic: the cell's files, for a cell that "
                                    "BENCHMARK.json does not hold")
    p.add_argument("--traffic")
    p.add_argument("--seed", type=int, nargs="+", required=True)
    p.add_argument("--out", help="a file the JSON lines are appended to")
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    bench = harness.load_benchmark()
    if args.config:
        bench["workloads"].append({"name": args.workload, "config": args.config,
                                   "traffic": args.traffic, "chips": 1})
    for i, seed in enumerate(args.seed):
        line = json.dumps(run_cell(bench, args.workload, seed, "cuda:0",
                                   t_start if i == 0 else time.perf_counter()))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
