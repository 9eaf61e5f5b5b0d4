#!/usr/bin/env python3
"""Smoke run of mic_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Setup: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit, builds the CUDA kernels from ``mic_tpu_torch/csrc`` and
   prints the build seconds and nvcc's per-kernel resource report.
2. Kernel vs plain: each kernel against its plain PyTorch version on the
   card, on the operands of the main path's buckets (CT_dev x256 = 1024
   strips of 512 steps, CT_dev_alias x256, MR_dev_alias x512, plus the
   alias kernel with fused=False), whole output array, tolerance 0.
   Times from CUDA events after a warm-up.
3. Main path: ``MicwDecodePlan`` over a mixed batch (CT_dev x256, the
   batch size the reference bench targets, plus MR_dev, MR_dev_alias,
   wide_banded and CT_dev_alias replicated); every strip of every
   replica is verified against the ``.raw`` pixels, and each kernel
   wrapper must have launched during the run.  Prints staging seconds,
   decode GB/s over ``plan.run()``, the launch counts and a torch.profiler
   breakdown of one ``plan.run()`` by device kernel.
4. Prints the kernel report as one JSON line, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Imports neither jax nor mic_tpu's device tier.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TESTDATA = ROOT / "web" / "testdata"
CT_ALIAS = ROOT / "tests" / "data" / "torch_port" / "CT_dev_alias.micw"

# name -> (container, expected pixels, replicas in the main-path batch)
BATCH = {
    "CT_dev": (TESTDATA / "CT_dev.micw", TESTDATA / "CT_dev.raw", 256),
    "MR_dev": (TESTDATA / "MR_dev.micw", TESTDATA / "MR_dev.raw", 32),
    "MR_dev_alias": (TESTDATA / "MR_dev_alias.micw", TESTDATA / "MR_dev_alias.raw", 32),
    "wide_banded": (TESTDATA / "wide_banded.micw", TESTDATA / "wide_banded.raw", 32),
    "CT_dev_alias": (CT_ALIAS, TESTDATA / "CT_dev.raw", 32),
}
KERNEL_REPLACES = {
    "rans_decode_zzd": "mic_tpu/tpu/pallas_rans.py:415",
    "rans_decode_alias": "mic_tpu/tpu/pallas_rans.py:567",
}


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the current stream, after one
    warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile(plan) -> None:
    """Device time of one ``plan.run()`` by kernel, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plan.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"profile: wall_ms={wall_ms:.3f}; no device events recorded "
              "(device breakdown not measured)")
        return
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    print(f"profile: one plan.run(): wall_ms={wall_ms:.3f} device_busy_ms={busy / 1e3:.3f} "
          f"device_span_ms={span / 1e3:.3f} idle_share_of_span={1 - busy / span:.3f} "
          f"device_events={len(kernels)}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile: {us / 1e3:8.3f} ms {100 * us / busy:5.1f}%  {name[:110]}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch._build import build, kernel_library
    from mic_tpu_torch.tpu import rans_decode as rd
    from mic_tpu_torch.tpu.strips import STRIP_MODE_CONST, STRIP_MODE_RAW, micw_parse

    dev = torch.device("cuda", 0)
    # --- 1. setup -----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    lib_path = build()
    kernel_library()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib_path.name})")
    log = lib_path.with_suffix(".log")
    if log.exists():  # absent when the library was built by an earlier run
        text = log.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", text))
        print(f"ptxas: {len(regs)} kernel instances, {min(regs)}-{max(regs)} registers, "
              f"{spills} bytes of spill stores")

    blobs = {k: v[0].read_bytes() for k, v in BATCH.items()}
    raws = {k: np.fromfile(v[1], dtype="<u2") for k, v in BATCH.items()}
    wrappers = {"rans_decode_zzd": (rd.rans_decode_zzd, rd.rans_decode_zzd_plain),
                "rans_decode_alias": (rd.rans_decode_alias, rd.rans_decode_alias_plain)}

    # --- 2. each kernel against its plain version, main-path shapes --------
    report = {name: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0} for name in wrappers}
    for name, reps in (("CT_dev", 256), ("CT_dev_alias", 256), ("MR_dev_alias", 512)):
        plan = MicwDecodePlan([blobs[name]] * reps, dev)
        for key, b in plan.buckets.items():
            variants = [b.kwargs]
            if b.fn is rd.rans_decode_alias and name == "MR_dev_alias":
                variants.append(dict(b.kwargs, vdd_ws=0, fused=False))
            for kw in variants:
                wname = b.fn.__name__
                kernel, plain = wrappers[wname]
                got = kernel(*b.ops, **kw)
                want = plain(*b.ops, **kw)
                torch.cuda.synchronize()
                err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
                if not torch.equal(got, want):
                    raise AssertionError(f"{wname} {name} {key} {kw}: kernel != plain "
                                         f"(max abs err {err})")
                ms = _cuda_ms(lambda: kernel(*b.ops, **kw), 10)
                plain_ms = _cuda_ms(lambda: plain(*b.ops, **kw), 2)
                r = report[wname]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if name in ("CT_dev", "CT_dev_alias"):  # one main-path image's buckets
                    r["ms"] += ms
                    r["plain_ms"] += plain_ms
                print(f"kernel-vs-plain {wname} {name}x{reps} bucket={key} "
                      f"strips={b.n} steps={kw['steps']} "
                      f"{'' if kw.get('fused', True) else 'fused=False '}"
                      f"equal=True kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}")
        del plan

    # --- 3. main path ---------------------------------------------------------
    names = [k for k, v in BATCH.items() for _ in range(v[2])]
    batch = [blobs[k] for k in names]
    expected = [raws[k] for k in names]
    timed_bytes = 0
    for k in names:
        bw, bh, _ns, strip_h, _mv, _gp, _lanes, strips = micw_parse(blobs[k])
        timed_bytes += 2 * sum(min(strip_h, bh - i * strip_h) * bw
                               for i, st in enumerate(strips)
                               if st[5] not in (STRIP_MODE_RAW, STRIP_MODE_CONST))
    rd.rans_decode_zzd.launches = 0
    rd.rans_decode_alias.launches = 0
    t0 = time.perf_counter()
    plan = MicwDecodePlan(batch, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = plan.run()
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, (fn, _p) in wrappers.items()}
    n_strips = sum(b.n for b in plan.buckets.values())
    mism = plan.verify_batch(decoded, expected)
    outs = plan.assemble(decoded)
    bad = [i for i, ((px, _w, _h), exp) in enumerate(zip(outs, expected))
           if px.dtype != np.uint16 or not np.array_equal(px, exp)]
    print(f"main path: {len(batch)} images, {n_strips} entropy strips in "
          f"{len(plan.buckets)} buckets, stage_s={stage_s:.3f} "
          f"first_run_s={first_run_s:.3f} mismatches={mism} bad_images={len(bad)} "
          f"launches={launches}")
    if mism or bad:
        raise AssertionError(f"main path decoded wrong pixels: {mism} mismatches, images {bad[:10]}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the main path")
    run_ms = _cuda_ms(plan.run, 5)
    print(f"main path decode: {run_ms:.3f} ms per plan.run(), "
          f"{timed_bytes / (run_ms / 1e3) / 1e9:.3f} GB/s of decoded u16 pixels "
          f"({timed_bytes} bytes)")

    _profile(plan)

    # --- 4. report ------------------------------------------------------------
    kernels = [{"name": name, "route": "cuda", "source": "mic_tpu_torch/csrc/rans_decode.cu",
                "replaces": KERNEL_REPLACES[name], "launches": launches[name],
                "max_abs_err": report[name]["max_abs_err"], "ms": report[name]["ms"],
                "plain_ms": report[name]["plain_ms"]} for name in wrappers]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
