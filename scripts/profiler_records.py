#!/usr/bin/env python3
"""Does torch.profiler keep one trace record for every launch of the
port's kernel library?  A reproducer, on one NVIDIA GPU.

    python3 scripts/profiler_records.py [--mode both|parent|teardown]
        [--age-s 180] [--step-s 20] [--big 30000] [--pad-ms 100]

It builds the port's CUDA library twice, as ``_build.build`` links it
(nvcc's default, the CUDA runtime linked statically) and with ``-cudart
shared`` (the runtime PyTorch loads), and profiles short windows in one
process: a torch kernel, ``--launches`` launches of the library's
YCoCg-R kernel through ctypes (16.5 M pixels), a torch kernel and a
synchronise, under ``torch.profiler.profile(activities=[CPU, CUDA])``.
Each window counts the device records (the library's against its
launches, torch's against 2) and the skew of each kernel record against
the host call that launched it (its CPU-side ``cudaLaunchKernel`` /
``cuLaunchKernel`` record, else the op the trace links it to).  A step
is five windows in rotating order: the two link forms, no library
launch, the static form with ``--pad-ms`` of host sleep inside the
session before and after the work, and the static form with every
thread of the process on one CPU; each step also prints each CPU's
TSC offset from the first's.  Steps run fresh, after one large trace
(``--big`` torch launches profiled) and every ``--step-s`` seconds up to
``--age-s`` seconds of process age.

``--mode both`` (the default) runs the schedule in two processes one
after the other: ``parent``, the profiler as the port used it before
(kineto keeps CUPTI initialised from one session to the next), and
``teardown``, as ``chip_smoke._profiled`` uses it (``TEARDOWN_CUPTI=1``:
kineto finalises CUPTI after each session and the next session
initialises it afresh, and CUDA calls after each session let the
finalise complete), and prints each one's losses by link form, pad,
pinning and position from ``--old-s`` seconds of age on, and each
one's summary as a JSON line.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PIXELS = 16_515_072  # phase 2's YCoCg-R planes (a 4608x3584 slide)
LINK = {"static": (), "shared": ("-cudart", "shared")}
LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


# (TSC, CLOCK_REALTIME ns) read together on the calling thread's CPU: the
# pair of n tries whose two clock reads lie closest
_TSC_PAIR_C = r"""
#include <stdint.h>
#include <time.h>
#include <x86intrin.h>
extern "C" void tsc_pair(int n, uint64_t* tsc, int64_t* ns) {
  int64_t best = INT64_MAX;
  for (int i = 0; i < n; ++i) {
    struct timespec a, b;
    clock_gettime(CLOCK_REALTIME, &a);
    const uint64_t t = __rdtsc();
    clock_gettime(CLOCK_REALTIME, &b);
    const int64_t na = a.tv_sec * 1000000000LL + a.tv_nsec;
    const int64_t nb = b.tv_sec * 1000000000LL + b.tv_nsec;
    if (nb - na < best) { best = nb - na; *tsc = t; *ns = na + (nb - na) / 2; }
  }
}
"""


def _clock_drift_us(t0_real: float, t0_mono: float) -> float:
    return ((time.time() - t0_real) - (time.monotonic() - t0_mono)) * 1e6


def _tsc_library():
    """The TSC pair reader, built with the host compiler into build/."""
    from mic_tpu_torch import _build

    src = _build.BUILD_DIR / "tsc_pair.cpp"
    lib = _build.BUILD_DIR / "libtsc_pair.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(_TSC_PAIR_C)
    subprocess.run([_build.host_compiler(), "-O2", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(lib)).tsc_pair
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = None
    return fn


def _tsc_pairs(fn) -> dict:
    """{cpu: (tsc, realtime ns)} read on each CPU this process may use (the
    calling thread moved from CPU to CPU, then back)."""
    tsc, ns = ctypes.c_uint64(), ctypes.c_int64()
    mine = os.sched_getaffinity(0)
    pairs = {}
    try:
        for cpu in sorted(mine):
            os.sched_setaffinity(0, {cpu})
            fn(2000, ctypes.byref(tsc), ctypes.byref(ns))
            pairs[cpu] = (tsc.value, ns.value)
    finally:
        os.sched_setaffinity(0, mine)
    return pairs


def _tsc_offsets_us(first: dict, now: dict) -> dict:
    """Per CPU, the error in us of converting its TSC to time with the
    first CPU's line through ``first`` and ``now`` (a TSC that differs
    between CPUs shows here)."""
    c0 = min(now)
    hz = (now[c0][0] - first[c0][0]) / ((now[c0][1] - first[c0][1]) / 1e9)
    return {cpu: round((ns - (now[c0][1] + (tsc - now[c0][0]) / hz * 1e9)) / 1e3, 3)
            for cpu, (tsc, ns) in now.items()}


def _pin_all_threads(cpus) -> dict:
    """Every thread of this process onto ``cpus``; returns each thread's
    former affinity."""
    former = {}
    for tid in map(int, os.listdir("/proc/self/task")):
        try:
            former[tid] = os.sched_getaffinity(tid)
            os.sched_setaffinity(tid, cpus)
        except OSError:  # the thread ended
            pass
    return former


def _restore_threads(former: dict) -> None:
    for tid, cpus in former.items():
        try:
            os.sched_setaffinity(tid, cpus)
        except OSError:
            pass


def _window(lib, planes, outs, x, n_launch: int, pad_s: float = 0.0, pin: bool = False,
            teardown: bool = False):
    """One profiled window, ``pad_s`` seconds of host sleep (the card
    idle) inside the session before and after the work; with ``pin``
    every thread of the process on one CPU from the session's start to
    the trace's end; with ``teardown`` the CUDA calls after the session
    that ``chip_smoke._profiled`` makes for CUPTI's finalise.  Returns
    (device records [(name, start us, duration us, skew us or None)],
    wall ms of the work, CPU-side launch records)."""
    import chip_smoke

    former = _pin_all_threads({min(os.sched_getaffinity(0))}) if pin else {}
    try:
        return _profiled_window(lib, planes, outs, x, n_launch, pad_s)
    finally:
        _restore_threads(former)
        if teardown:
            chip_smoke._finish_cupti_teardown()


def _profiled_window(lib, planes, outs, x, n_launch: int, pad_s: float):
    import torch
    from torch.profiler import ProfilerActivity, profile

    stream = torch.cuda.current_stream().cuda_stream
    args = (*(t.data_ptr() for t in planes), *(t.data_ptr() for t in outs), PIXELS, 0, stream)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        t0 = time.perf_counter()
        x.add_(1)
        for _ in range(n_launch):
            rc = lib.mic_ycocgr(*args)
            if rc:
                raise RuntimeError(f"mic_ycocgr: CUDA error {rc}")
        x.add_(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(pad_s)
    events = list(prof.events())
    launch_calls, ops = {}, {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU:
            (launch_calls if e.name in LAUNCH_NAMES else ops)[e.id] = e
    recs = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        host = launch_calls.get(e.id) or ops.get(getattr(e, "linked_correlation_id", -1))
        skew = None if host is None else e.time_range.start - host.time_range.start
        recs.append((e.name, e.time_range.start, e.time_range.elapsed_us(), skew))
    return recs, wall_ms, len(launch_calls)


def _schedule(a, teardown: bool) -> dict:
    """The windows of one process, from its start; returns its summary."""
    if teardown:
        os.environ["TEARDOWN_CUPTI"] = "1"  # before the first session, as chip_smoke does
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from mic_tpu_torch import _build

    t0_real, t0_mono = time.time(), time.monotonic()
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}; "
          f"TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI')}")
    libs = {name: _build.kernel_library((), link) for name, link in LINK.items()}
    maps = Path("/proc/self/maps").read_text().splitlines()
    cudarts = sorted({ln.split()[-1] for ln in maps if "libcudart" in ln})
    print(f"built both forms in {time.perf_counter() - t_start:.3f} s; libcudart mapped: {cudarts}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(0)
    planes = [torch.randint(0, 1 << 15, (PIXELS,), generator=gen, dtype=torch.int16).to(dev)
              for _ in range(3)]
    outs = [torch.empty_like(p) for p in planes]
    x = torch.zeros(1 << 20, device=dev)
    # (link form or None for no library launch, pad seconds, threads pinned)
    variants = ([(name, 0.0, False) for name in libs] + [(None, 0.0, False)]
                + [("static", pad / 1e3, False) for pad in a.pad_ms] + [("static", 0.0, True)])
    tsc = _tsc_library()
    tsc_first = _tsc_pairs(tsc)
    rows = []

    def windows(stage: str, step: int) -> None:
        k = step % len(variants)
        offsets = _tsc_offsets_us(tsc_first, _tsc_pairs(tsc)) if step else {}
        print(f"step {step}: TSC offsets from CPU {min(tsc_first)}, us: {offsets}")
        for pos, (name, pad_s, pin) in enumerate(variants[k:] + variants[:k]):
            n = a.launches if name else 0
            recs, wall_ms, n_launch_rec = _window(libs[name or "static"], planes, outs, x, n,
                                                  pad_s, pin, teardown)
            port = sum(1 for r in recs if "ycocgr" in r[0])
            row = {"stage": stage, "step": step, "position": pos,
                   "age_s": round(time.perf_counter() - t_start, 3),
                   "realtime_drift_us": round(_clock_drift_us(t0_real, t0_mono), 3),
                   "link": name or "none", "pad_ms": pad_s * 1e3, "pinned": pin,
                   "port_records": port, "port_launches": n,
                   "torch_records": len(recs) - port, "torch_launches": 2,
                   "launch_call_records": n_launch_rec, "wall_ms": round(wall_ms, 3),
                   "skew_us": [round(r[3], 3) for r in recs if r[3] is not None]}
            row["lost"] = n + 2 - len(recs)
            rows.append(row)
            print("window " + " ".join(f"{k}={v}" for k, v in row.items()))

    windows("fresh", 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(a.big):
            x.add_(1)
        torch.cuda.synchronize()
    n_big = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"large trace: {n_big} device records for {a.big} launches")
    del prof
    if teardown:
        chip_smoke._finish_cupti_teardown()
    windows("after the large trace", 1)
    step, next_t = 2, a.step_s
    while next_t <= a.age_s:
        while time.perf_counter() - t_start < next_t:
            x.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.05)
        windows("aged", step)
        step, next_t = step + 1, next_t + a.step_s
    old = [r for r in rows if r["age_s"] >= a.old_s]
    by_variant = {}
    for name, pad_s, pin in variants:
        rs = [r for r in old if (r["link"], r["pad_ms"], r["pinned"])
              == (name or "none", pad_s * 1e3, pin)]
        kept = [v for r in rs for v in r["skew_us"][1:]]  # the first launch's queueing aside
        by_variant[f"link={name or 'none'} pad_ms={pad_s * 1e3:g} pinned={pin}"] = {
            "windows": len(rs), "windows_lost": sum(r["lost"] > 0 for r in rs),
            "records_lost": sum(r["lost"] for r in rs),
            "kept_skew_us": [min(kept, default=0), max(kept, default=0)]}
    by_position = {pos: [sum(r["lost"] > 0 for r in old if r["position"] == pos),
                         sum(1 for r in old if r["position"] == pos)]
                   for pos in range(len(variants))}
    return {"teardown": teardown, "windows": len(rows),
            "windows_lost": sum(r["lost"] > 0 for r in rows), "big_records": n_big,
            "from_age_s": a.old_s, "by_variant": by_variant, "by_position": by_position,
            "rows": rows}


def _report(summary: dict) -> None:
    print(f"mode {'teardown' if summary['teardown'] else 'parent'}: "
          f"{summary['windows_lost']} of {summary['windows']} windows lost records; "
          f"from {summary['from_age_s']} s of age on:")
    for key, v in summary["by_variant"].items():
        print(f"  {key}: {v['windows_lost']} of {v['windows']} windows lost "
              f"{v['records_lost']} records; skew us of the kept records "
              f"{v['kept_skew_us'][0]:.3f} to {v['kept_skew_us'][1]:.3f}")
    for pos, (lost, n) in summary["by_position"].items():
        print(f"  position {pos} in its step: {lost} of {n} windows lost records")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("both", "parent", "teardown"), default="both")
    ap.add_argument("--age-s", type=float, default=180.0)
    ap.add_argument("--step-s", type=float, default=20.0)
    ap.add_argument("--big", type=int, default=30000, help="torch launches of the large trace")
    ap.add_argument("--launches", type=int, default=4, help="library launches a window")
    ap.add_argument("--pad-ms", type=float, nargs="*", default=[100.0],
                    help="pads of the padded windows (link form static)")
    ap.add_argument("--old-s", type=float, default=60.0,
                    help="the age from which the summary counts windows")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profiler_records: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if a.mode != "both":
        summary = _schedule(a, a.mode == "teardown")
        _report(summary)
        print(json.dumps(summary))
        return 0
    summaries = []
    env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
    for mode in ("parent", "teardown"):
        argv = [sys.executable, __file__, "--mode", mode, "--age-s", str(a.age_s),
                "--step-s", str(a.step_s), "--big", str(a.big), "--launches", str(a.launches),
                "--pad-ms", *map(str, a.pad_ms), "--old-s", str(a.old_s)]
        res = subprocess.run(argv, capture_output=True, text=True, env=env)
        print(res.stdout, end="")
        sys.stderr.write(res.stderr)
        if res.returncode:
            return res.returncode
        summaries.append(json.loads(res.stdout.strip().splitlines()[-1]))
    for summary in summaries:
        _report(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
