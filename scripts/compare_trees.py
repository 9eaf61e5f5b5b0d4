#!/usr/bin/env python3
"""Runs some of ``chip_smoke.py``'s phases in two trees of this repository
on one card, each run in a process of its own, in the order other, this,
this, other.

    python3 scripts/compare_trees.py DIR [--phases 2r,2d,2p,2e,2post,2l,3,4,5,6,8,10,14] [--reps N]

``DIR`` is an unpacked copy of another commit (for example the parent:
``git archive HEAD | tar -x -C build/parent``).  Each run imports the
``chip_smoke.py`` and ``mic_tpu_torch`` of its own tree, builds that
tree's kernels (and its C++ host tier, where it has one), and runs the
phases with that tree's functions, so both
sides are measured by the same code as far as the trees share it:

* ``2r``: each r-mode bucket of phase 5's batch through its one-bucket
  wrapper (``b.fn(*b.ops, **b.kwargs)``, the call phase 2 times for PERF.md
  rows 4 and 5), CUDA events, mean of ``--reps`` after a warm-up, summed
  per wrapper;
* ``2d``: the same for each direct bucket of CT_dev x256 and CT_dev_alias
  x256 (PERF.md rows 1 and 2);
* ``2p``: the same for each post bucket of phase 6's batch and of
  CT_dev_1strip_tl15 x32 (PERF.md rows 6 and 7, the two-table wrapper
  split by tableLog);
* ``2e``: both forms of the encode kernel on phase 2's operands (CT_dev
  x128's 1536 candidate streams of 512 steps, PERF.md row 3) through
  their wrappers, with the per-stream table widths where the tree's
  staging has them (the main path's call), and ns a step of the launch;
* ``2post``: the post kernel alone, one ``post.post_decode_groups`` call
  with the plan's packing on the entropy launches' symbols of phase 6's
  batch and of phase 8's tile batch (``tissue_dev.mwr3`` x64; PERF.md row
  13), milliseconds from CUDA events around ``--reps`` calls queued
  behind a spinning kernel (``torch.cuda._sleep``), so the host's time to
  launch is not counted, after a warm-up;
* ``2l``: the lanes kernel alone on each scan bucket of phase 10's batch
  (``chip_smoke._scan_batch``; its 32- and 256-lane buckets hold FF 57
  strips only, its 128-lane ones FF 41 only, its 64-lane ones both), one
  packing a bucket in the warp form (with the bucket's inverse) and in
  the block form (symbols out), CUDA events, mean of ``--reps`` after a
  warm-up, with ns a step of the bucket's chain;
* ``3``: phase 3's plan (``MicwDecodePlan`` over ``chip_smoke.BATCH``):
  its staging seconds, verified, then ms and GB/s per ``plan.run()``
  (CUDA events, mean of ``--reps``) and the device busy time of one run
  (torch.profiler);
* ``4``, ``5``, ``6``, ``8``, ``10``: the tree's own phase function
  (encode path, r-mode plan, post path, RGB / WSI containers, scan tier),
  which verifies its outputs and prints its times (phase 4: its total
  line, with the profiled ``kernel_ms``); a tree without the phase says
  so;
* ``14``: the host tier on phase 12's 2048x2048 CT mosaic, with what
  both trees have: the mosaic's MIC1 (2 / 4 / 8 states, rANS8) and PICS
  (4 and 8 states, 8 strips) written by the tree's writers in spawned
  processes (host seconds a writer), ``decode_frame`` (``tier="auto"``)
  of each MIC1 and ingest's default reference decode of each PICS (host
  seconds of the least of ``--reps`` calls, at most 3, one where a call
  takes over a second; pixels verified),
  and ``ingest_plan(..., device_encode=True)`` at its default tier on the
  six blobs with its ``decode_s`` / ``encode_s`` / ``stage_s``.  A tree
  before the C++ host tier runs its Python tier under those names.

Prints the card's name and power limit, then each run's timing lines
(``ms per``, ``GB/s``, the profiler's idle share) under its tree's label.
Needs an NVIDIA GPU and nvcc.  Imports neither jax nor anything of
mic_tpu.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
KEEP = (" ms per ", "GB/s", "idle_share", "r-wrapper", "d-wrapper", "p-wrapper", "e-wrapper",
        "post-launch", "l-bucket",
        "encode path: ", "scan tier: ", "profile: ", "stage_s", "host 14: ")

RUN = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from mic_tpu_torch import _build
dev = torch.device("cuda", 0)
_build.kernel_library()
getattr(_build, "host_library", lambda: None)()  # set-up, as the kernels' (a tree may lack it)
phases = {phases!r}
if "2r" in phases:
    from mic_tpu_torch import MicwDecodePlan
    plan = MicwDecodePlan(cs._r_batch()[0], dev)
    per = {{}}
    for b in plan.buckets.values():
        name = b.fn.__name__
        per[name] = per.get(name, 0.0) + cs._cuda_ms(lambda: b.fn(*b.ops, **b.kwargs), {reps})
    for name, ms in per.items():
        print(f"r-wrapper {{name}}: {{ms:.3f}} ms per its buckets' calls, each bucket alone")
    del plan
if "2d" in phases:
    from mic_tpu_torch import MicwDecodePlan
    per = {{}}
    for name in ("CT_dev", "CT_dev_alias"):
        plan = MicwDecodePlan([cs.BATCH[name][0].read_bytes()] * 256, dev)
        for b in plan.buckets.values():
            fn = b.fn.__name__
            per[fn] = per.get(fn, 0.0) + cs._cuda_ms(lambda: b.fn(*b.ops, **b.kwargs), {reps})
        del plan
    for name, ms in per.items():
        print(f"d-wrapper {{name}}: {{ms:.3f}} ms per its buckets' calls, each bucket alone")
if "2p" in phases:
    from mic_tpu_torch import MicwDecodePlan
    per = {{}}
    for blobs in (cs._post_batch(dev)[0], [cs.CT_TL15.read_bytes()] * 32):
        plan = MicwDecodePlan(blobs, dev)
        for k, b in plan.buckets.items():
            if k[0] != "post":
                continue
            fn = b.fn.__name__
            if fn == "rans_decode":
                fn += f" tl {{b.ops[1].shape[1].bit_length() - 1}}"
            per[fn] = per.get(fn, 0.0) + cs._cuda_ms(lambda: b.fn(*b.ops, **b.kwargs), {reps})
        del plan
    for name, ms in per.items():
        print(f"p-wrapper {{name}}: {{ms:.3f}} ms per its buckets' calls, each bucket alone")
if "2e" in phases:
    import numpy as np
    from mic_tpu_torch.tpu import rans_encode as renc
    from mic_tpu_torch.tpu.strips import ALIAS_TABLE_LOG, MAX_TABLE_LOG, micw_parse
    blob = (cs.TESTDATA / "CT_dev.micw").read_bytes()
    w, h, _n, _s, mv = micw_parse(blob)[:5]
    px = np.fromfile(cs.TESTDATA / "CT_dev.raw", dtype="<u2")
    for alias, fn in ((False, renc.rans_encode), (True, renc.rans_encode_alias)):
        plan = renc.MicwEncodePlan([(px, w, h, mv)], "alias" if alias else "standard",
                                   "auto-fast")
        staged = renc.stage_encode_batch(
            [j[0] for j in plan.jobs[alias]], on_error="none", alias=alias,
            max_table_log=ALIAS_TABLE_LOG if alias else MAX_TABLE_LOG)
        ops = renc.staged_to_device(staged, dev)
        ops = tuple(t.repeat((128,) + (1,) * (t.dim() - 1)) for t in ops)
        kw = {{"steps": staged.steps}}
        if hasattr(staged, "widths"):
            kw["widths"] = torch.from_numpy(staged.widths).to(dev).repeat(128)
        ms = cs._cuda_ms(lambda: fn(*ops, **kw), {reps})
        print(f"e-wrapper {{fn.__name__}}: {{ms:.3f}} ms per call, {{ms * 1e6 / staged.steps:.1f}} "
              f"ns a step of the launch, {{ops[0].shape[0]}} streams x {{staged.steps}} steps")
if "2post" in phases:
    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch.tpu import post, rgb_device
    tiles = [(cs.TESTDATA / "tissue_dev.mwr3").read_bytes()] * 64
    for label, plan in (("phase 6", MicwDecodePlan(cs._post_batch(dev)[0], dev)),
                        ("phase 8 tiles", rgb_device._stage(tiles, dev)[1])):
        outs = cs._entropy_outputs(plan)
        groups = [(outs[k], *g) for k, g in zip(plan._post_keys, plan._post_groups)]
        pk = plan.post_packing
        post.post_decode_groups(groups, pk)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range({reps}):
            post.post_decode_groups(groups, pk)
        end.record()
        torch.cuda.synchronize()
        print(f"post-launch {{label}}: {{start.elapsed_time(end) / {reps}:.3f}} ms per "
              f"post_decode_groups call, device time ({{len(pk.blocks)}} strips)")
        del plan, outs, groups
if "2l" in phases:
    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch.tpu import scan_decode as sd
    plan = MicwDecodePlan(cs._scan_batch()[0], dev)
    for k in plan._scan_keys:
        b = plan.buckets[k]
        tls = sorted({{int(t) for t in b.ops[6].cpu()}})
        steps = b.kwargs["steps"]
        for form, warp_lanes, kw in (("warp", sd.WARP_LANES, b.kwargs),
                                     ("block", 0, {{"steps": steps}})):
            pk = sd.LanesPacking([(b.fn, b.ops, kw)], warp_lanes=warp_lanes)
            ms = cs._cuda_ms(lambda: sd._lanes_launch(pk), {reps})
            print(f"l-bucket {{k[1]}} lanes {{k[3]}} x{{b.n}} tl {{tls}} {{form}}: {{ms:.3f}} ms, "
                  f"{{ms * 1e6 / steps:.1f}} ns a step")
    del plan
if "3" in phases:
    import numpy as np
    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch.tpu.strips import micw_parse
    names = [k for k, v in cs.BATCH.items() for _ in range(v[2])]
    blobs = {{k: v[0].read_bytes() for k, v in cs.BATCH.items()}}
    raws = {{k: np.fromfile(v[1], dtype="<u2") for k, v in cs.BATCH.items()}}
    nbytes = 0
    for k in names:
        bw, bh, _n, sh, _m, _g, _l, strips = micw_parse(blobs[k])
        nbytes += 2 * sum(min(sh, bh - i * sh) * bw for i, st in enumerate(strips)
                          if st[5] not in (1, 5))  # raw and constant strips: the host's
    import time
    t0 = time.perf_counter()
    plan = MicwDecodePlan([blobs[k] for k in names], dev)
    torch.cuda.synchronize()
    print(f"phase 3: stage_s={{time.perf_counter() - t0:.3f}}")
    mism = plan.verify_batch(plan.run(), [raws[k] for k in names])
    ms = cs._cuda_ms(plan.run, {reps})
    _o, wall, by_name, span = cs._profiled(plan.run)
    busy = sum(by_name.values())
    print(f"phase 3: {{ms:.3f}} ms per plan.run(), {{nbytes / ms / 1e6:.3f}} GB/s, "
          f"mismatches={{mism}}; profile: device_busy_ms={{busy:.3f}} "
          f"idle_share_of_span={{1 - busy / span if span else float('nan'):.3f}}")
    del plan
if "4" in phases:
    cs._encode_phase(dev)
if "5" in phases:
    cs._rle_phase(dev)
if "6" in phases:
    cs._post_phase(dev, *cs._post_batch(dev))
if "8" in phases:
    cs._rgb_wsi_phase(dev, cs._slide()[0])
if "10" in phases:
    if hasattr(cs, "_scan_phase"):
        report = {{name: {{"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}}
                  for name in cs.KERNELS}}
        cs._scan_phase(dev, *cs._scan_batch(), report)
    else:
        print("scan tier: phase 10 is not in this tree")
if "14" in phases:
    import multiprocessing
    import time
    from concurrent.futures import ProcessPoolExecutor
    import numpy as np
    from mic_tpu_torch import ingest_plan
    from mic_tpu_torch.models import single_frame as sf
    from mic_tpu_torch.tpu import ingest
    from mic_tpu_torch.utils.io import read_mic1
    copies = cs.MOSAIC_COPIES
    jobs = [("mic1", (k, copies)) for k in ("2s", "4s", "8s", "rans8")] + [
        ("pics", (n, copies)) for n in (4, 8)]
    with ProcessPoolExecutor(max_workers=len(jobs),
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        written = dict(zip(jobs, ex.map(cs._writer_job, jobs)))
    flat = cs._mosaic(copies).ravel()
    side = 512 * copies
    mb = flat.nbytes / 1e6
    for job, (label, blob, n_in, sec) in written.items():
        print(f"host 14: writer {{label}}: {{sec:.3f}} host s, {{n_in / sec / 1e6:.3f}} MB/s")
    reps = min({reps}, 3)
    blobs = []
    for (kind, arg), (label, blob, _n, _s) in written.items():
        if kind == "mic1":
            blob = read_mic1(blob)[3]
            fn = lambda: sf.decode_frame(blob, side, side)
            what = "decode_frame(tier='auto')"
        else:
            fn = lambda: ingest._decode_reference(blob, 0, 0, 0, dev)[0]
            what = "ingest's default reference decode"
        blobs.append(blob)
        best = float("inf")
        for _ in range(reps):  # a call over a second is not repeated
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
            if best > 1.0:
                break
        assert np.array_equal(np.asarray(out), flat), label
        print(f"host 14: {{what}} {{label}}: {{best:.4f}} host s, {{mb / best:.3f}} MB/s")
    timings = {{}}
    t0 = time.perf_counter()
    plan = ingest_plan(blobs, [(side, side)] * 4 + [None] * 2, dev, device_encode=True,
                       timings=timings)
    wall = time.perf_counter() - t0
    mism = plan.verify_batch(plan.run(), [flat] * len(blobs))
    assert not mism, mism
    print(f"host 14: ingest_plan(device_encode=True) default tier: {{wall:.3f}} s, "
          + " ".join(f"{{k}}={{v:.3f}}" for k, v in timings.items()))
"""


def _run(tree: Path, phases: list[str], reps: int) -> list[str]:
    res = subprocess.run([sys.executable, "-c", RUN.format(phases=phases, reps=reps)],
                         cwd=tree, capture_output=True, text=True)
    if res.returncode:
        sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
        raise SystemExit(f"compare_trees: the run in {tree} failed ({res.returncode})")
    return [ln for ln in res.stdout.splitlines() if any(k in ln for k in KEEP)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("other", help="an unpacked tree of another commit")
    ap.add_argument("--phases", default="2r,5,6,8")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("compare_trees: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    phases = args.phases.split(",")
    other = Path(args.other).resolve()
    for label, tree in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        for line in _run(tree, phases, args.reps):
            print(f"[{label} {tree.name}] {line}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
