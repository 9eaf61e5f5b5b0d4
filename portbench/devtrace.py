"""The device trace of a stretch of requests, from torch.profiler.

A copy of the repository's checked profiler window (``_profiled`` in
``chip_smoke.py``), kept here so that later changes to the program's
scripts cannot change the yardstick.  It keeps that window's two
guards:

- the trace must hold one record of each launch that the port's kernel
  wrappers counted (their ``.launches``) during the stretch, kernel by
  kernel, or ``LostRecords`` is raised: a trace that lost records would
  read low (the harness serves such a stretch again in a new session and
  fails the run if that one loses records too);
- ``TEARDOWN_CUPTI=1``: kineto finalises CUPTI at the end of the session,
  and a few synchronises let that finalise complete before the process
  goes on (while CUPTI stays initialised, the device timestamps of a
  process older than a minute drift, and kineto drops the records that
  fall outside its session).

It adds a host sleep of ``PAD_S`` inside the session before and after the
traced work: one window in about seventy lost one record of a thousand
launches without it.  Inside those, it launches ``MARKERS`` one-element
kernels on an idle card before and after the work, which put the card's
records on the host's wall clock (``time.time_ns()``, the clock of the
program's spans): kineto's clock for them is off by up to hundreds of
microseconds in some profiler sessions and drifts within one on an H100
machine (``clock_offsets``, ``on_host_clock``).

It records device activity only: the CPU side of the profiler records
every torch operator, and a request that gathers a study of two thousand
images runs thousands of them, which would slow the host it measures
many times over and take minutes to read back.
"""

from __future__ import annotations

import os
import time

import numpy as np

TEARDOWN_SYNCS = 10  # synchronises after the session, for CUPTI's finalise
PAD_S = 0.1  # host sleep inside the session before and after the traced work
NAME_CHARS = 120  # characters of a kernel name kept in the breakdown
MARKERS = 10  # marker launches before and after the traced work, for the clocks


class LostRecords(AssertionError):
    """The trace does not hold one record of each counted port launch."""


def port_kernels() -> dict:
    """Kernel names in the trace -> the port's wrappers that launch those
    kernels (each adds one to its ``.launches`` a launch)."""
    from mic_tpu_torch.tpu import kernels, post, verify
    from mic_tpu_torch.tpu import rans_decode as rd
    from mic_tpu_torch.tpu import rans_encode as renc
    from mic_tpu_torch.tpu import scan_decode as sd
    from mic_tpu_torch.tpu import tans_decode as td

    return {
        ("direct_groups_kernel",): (rd.rans_decode_zzd, rd.rans_decode_alias,
                                    rd.rans_decode_packed, rd.rans_decode,
                                    rd.rans_decode_direct_groups),
        ("rle_groups_kernel",): (rd.rans_decode_rle, rd.rans_decode_rle_alias,
                                 rd.rans_decode_rle_groups),
        ("rans_enc_kernel",): (renc.rans_encode, renc.rans_encode_alias),
        ("tans_groups_kernel",): (td.tans_decode, td.tans_decode_groups),
        ("ycocgr_fwd_kernel",): (kernels.ycocgr_forward,),
        ("ycocgr_inv_kernel",): (kernels.ycocgr_inverse,),
        ("wt53_fwd_kernel",): (kernels.wt53_rows_forward,),
        ("wt53_inv_kernel",): (kernels.wt53_rows_inverse,),
        ("lanes_groups_kernel", "lanes_wide_kernel"): (sd.rans_decode_lanes,
                                                       sd.rans_decode_lanes_groups),
        ("mismatch_groups_kernel",): (verify.count_mismatches,),
        ("post_groups_kernel",): (post.post_decode_groups,),
    }


def is_port_kernel(name: str, port: dict) -> bool:
    return any(n in name for names in port for n in names)


def _finish_cupti_teardown() -> None:
    import torch

    for _ in range(TEARDOWN_SYNCS):
        torch.cuda.synchronize()
        time.sleep(0.001)


def profiled(fn, device):
    """``fn()`` under torch.profiler on the card, with ``MARKERS`` marker
    launches on ``device`` before and after it: (result, records [(name,
    start ns, end ns)] on the host's wall clock sorted by start, without
    the markers; the trace clock's error (ns) left at the markers before
    and after once the records are placed by the markers before: about
    0, and the drift over the work).  The trace's clock for the card's
    records differs from the host's by an amount that changes between
    profiler sessions and drifts within one, so each session measures it
    with the markers.  On the CPU: (``fn()``, [], None), no trace.
    Raises ``LostRecords`` where the trace does not hold one record a
    counted port launch."""
    import torch

    if not torch.cuda.is_available():
        return fn(), [], None
    return _placed(fn, device)


def _placed(fn, device):
    """``profiled`` on the card: the session, the markers and the records
    placed on the wall clock."""
    import torch

    x = torch.zeros(1, device=device)

    def marked():
        first = _markers(x, MARKERS)
        out = fn()
        return first, out, _markers(x, MARKERS)

    (first, out, last), spans = _profiled(marked)
    raw = [(name, round(1e9 * s), round(1e9 * e)) for name, s, e in spans]
    # the trace's seconds from its start, on the wall clock as the markers
    # before the work put them (the first records: the card is idle then),
    # in whole ns; the markers measure what is left
    shifts = sorted((t0 + t1) // 2 - r[1] for r, (t0, t1) in zip(raw, first))
    shift = shifts[len(shifts) // 2] if shifts else 0
    at, off, records = clock_offsets([(n, s + shift, e + shift) for n, s, e in raw], first, last)
    return out, sorted(on_host_clock(records, at, off), key=lambda r: r[1]), off


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


def in_seconds(records) -> list[tuple[str, float, float]]:
    """Records [(name, start ns, end ns)] as seconds from the first start,
    for ``summarize``."""
    base = records[0][1] if records else 0
    return [(name, 1e-9 * (s - base), 1e-9 * (e - base)) for name, s, e in records]


def _profiled(fn):
    """Run ``fn()`` under torch.profiler (device activity); returns
    (result, device intervals [(name, start s, end s)] sorted by start).
    Raises LostRecords where the trace does not hold one record a
    launch the port's wrappers counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.environ["TEARDOWN_CUPTI"] = "1"
    port = port_kernels()
    before = {k: sum(w.launches for w in ws) for k, ws in port.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the work away from the session's edges, where a record can be lost
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    _finish_cupti_teardown()
    lost = {}
    for names, ws in port.items():
        launched = sum(w.launches for w in ws) - before[names]
        held = sum(1 for e in events if any(n in e.name for n in names))
        if launched != held:
            lost[names[0]] = (launched, held)
    if lost:
        raise LostRecords(f"torch.profiler's trace does not hold one record a port launch "
                             f"(kernel: launches, records): {lost}")
    spans = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6) for e in events]
    return out, sorted(spans, key=lambda sp: sp[1])


def summarize(spans, port: dict) -> dict:
    """Device seconds by name, the busy seconds (the union of the
    intervals), the span from the first start to the last end, and the
    idle gaps between intervals, each named by the operations on either
    side of it (the host was running the Python between their launches)."""
    by_name: dict[str, float] = {}
    gaps: dict[str, float] = {}
    busy = 0.0
    end = prev = None
    for name, s, e in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if end is not None and s > end:
            label = f"host before {_short(name, port)} (after {_short(prev, port)})"
            gaps[label] = gaps.get(label, 0.0) + (s - end)
        if end is None or s > end:
            busy += e - s
        elif e > end:
            busy += e - end
        if end is None or e > end:
            end, prev = e, name
    span = max((e for _n, _s, e in spans), default=0.0) - min((s for _n, s, _e in spans),
                                                              default=0.0)
    return {"by_name": by_name, "busy_s": busy, "span_s": span, "gaps": gaps}


def _short(name: str, port: dict) -> str:
    """A kernel's name for a gap's label: the port's kernel names whole,
    torch's by the operator in them."""
    for names in port:
        for n in names:
            if n in name:
                return n
    key = name.lower().replace("_", "")
    for op in ("indexselect", "indexcopy", "indexput", "fill", "memcpy", "memset", "copy",
               "cat", "reduce", "elementwise"):
        if op in key:
            return op
    return name[:40]


def breakdown(summary: dict, outside_s: float) -> dict:
    """The result line's breakdown: the ten device operations that took
    most time and the ten longest idle stretches by what the host was
    doing, each [name, seconds]."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:10]
    gaps = dict(summary["gaps"])
    gaps["host outside the device span (before the first launch, after the last)"] = outside_s
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in idle]}
