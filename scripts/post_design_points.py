#!/usr/bin/env python3
"""Times the post kernel, ``csrc/post.cu``, in its design points on the card.

    python3 scripts/post_design_points.py [--reps N] [--builds NAME,...]

Builds ``post.cu``'s forms with its ``MIC_POST_*`` macros into libraries of
their own (each through ``_build.kernel_library(defines)``) and times each
on the same operands, launched through the private
``post._post_launch(packing, ents, lib)`` (uncounted):

* ``default``: the kernel as shipped (8 words a warp a chunk of the
  parse, runs and flag bits in shared memory, ``__launch_bounds__(256,
  4)``: at most 64 registers a thread);
* ``runs``: the runs stage alone (``MIC_POST_STAGE=0``): no output, so
  nothing to check;
* ``parse``: through the expand and the escape parse, no inverse
  (``MIC_POST_STAGE=1``): the parsed values of the zz / avg strips, the
  tokens of the r-modes, the symbols of the direct modes;
* ``inverse``: everything but the expand and the parse
  (``MIC_POST_STAGE=3``): the inverses on whatever the output rows hold,
  so a time and nothing to check;
* ``words4``: 4 words a warp a chunk of the parse and the expand
  (``MIC_POST_WORDS``);
* ``scratch``: the runs and the flag bits in device scratch always
  (``MIC_POST_RUNS_SMEM=0``, ``MIC_POST_FLAG_BITS=0``);
* ``minblocks5``: ``__launch_bounds__(256, 5)`` (``MIC_POST_MIN_BLOCKS``):
  at most 48 registers a thread;
* ``avgwin2``: avg windows of 2 steps, not 4 (``MIC_POST_AVG_WIN``).

Operands: the post buckets of ``chip_smoke.py``'s phase 6 batch and of
phase 8's tile batch (``tissue_dev.mwr3`` x64), each on the entropy
launches' symbols, in one launch and split by kind (zz, avg, the r-modes,
the direct modes), each subset in a launch of its own.  Every output
must equal its plain twin's before its time counts: ``post.post_batch``
for the whole stage, its ``soa_rle_expand`` / ``parse_escaped`` for the
``parse`` cut-off.  Milliseconds from CUDA events around ``--reps``
launches queued behind a spinning kernel (``torch.cuda._sleep``), so the
host's time to launch is not counted, after a warm-up; the forms of a
subset in turns, twice (the second round in reverse order, the lesser
time kept).  Then each form's launch shape (shared bytes a block,
blocks an SM, registers a thread, from ``mic_post_shape``), ptxas' lines
for ``post_groups_kernel`` from the build's log, and a JSON summary.
Needs an NVIDIA GPU and nvcc.  Imports neither jax nor anything of mic_tpu.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# name -> (nvcc defines, stage: 0 runs, 1 parse, 2 whole, 3 the inverses alone)
BUILDS = {"default": ((), 2), "runs": (("-DMIC_POST_STAGE=0",), 0),
          "parse": (("-DMIC_POST_STAGE=1",), 1), "inverse": (("-DMIC_POST_STAGE=3",), 3),
          "words4": (("-DMIC_POST_WORDS=4",), 2),
          "scratch": (("-DMIC_POST_RUNS_SMEM=0", "-DMIC_POST_FLAG_BITS=0"), 2),
          "minblocks5": (("-DMIC_POST_MIN_BLOCKS=5",), 2),
          "avgwin2": (("-DMIC_POST_AVG_WIN=2",), 2)}
CHECKED = (1, 2)  # the stages with an output to hold against the plain twin
KINDS = {"zz": ("zz",), "avg": ("avg",), "r-modes": ("zzr", "vdr", "pdr"),
         "direct": ("zzd", "vdd", "pdd")}


def _stage_plain(groups, stage: int):
    """The plain twin's outputs of ``groups`` ([(ent, meta, kw)]) through
    ``stage`` (1: no inverse, 2: all), int16 bit-views."""
    import torch

    from mic_tpu_torch.tpu import post

    out = []
    for e, m, kw in groups:
        if stage == 2:
            out.append(post.post_batch(e, m[:, 0], m[:, 1], m[:, 2], **kw))
            continue
        syms = e.reshape(e.shape[0], -1).to(torch.int64) & 0xFFFF
        need, pred = kw["width"] * kw["strip_h"], kw["predictor"]
        if pred in ("zzd", "vdd", "pdd"):
            vals = syms
        else:
            vals, _n = post.soa_rle_expand(syms, m[:, 1], m[:, 2], kw["mid_count"],
                                           kw["max_runs"], kw["max_tokens"])
            if pred in ("zz", "avg"):
                vals, _raw = post.parse_escaped(vals[:, 1:], m[:, :1] - 1, kw["delim"], need)
        vals = post._pad_cols(vals, need)[:, :need]
        out.append((((vals & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16))
    return out


def _device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()``: ``reps`` calls queued behind
    a spinning kernel, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ptxas_lines(defines) -> list[str]:
    """ptxas' register, shared-memory and spill lines for the post kernel
    in the build log of the library built with ``defines``."""
    from mic_tpu_torch._build import library_path

    log = library_path(defines).with_suffix(".log").read_text().splitlines()
    keep, on = [], False
    for ln in log:
        if "Compiling entry function" in ln:
            on = "post_groups_kernel" in ln
        if on and ("registers" in ln or "spill" in ln or "bytes stack" in ln):
            keep.append(ln.strip())
    return keep


def main() -> int:
    import torch

    import chip_smoke as cs
    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch._build import kernel_library
    from mic_tpu_torch.tpu import post, rgb_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--builds", default=",".join(BUILDS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("post_design_points: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    builds = {n: BUILDS[n] for n in args.builds.split(",")}
    libs = {n: kernel_library(d) for n, (d, _stage) in builds.items()}
    summary = {"design_points": [], "shapes": {}}
    tiles = [(cs.TESTDATA / "tissue_dev.mwr3").read_bytes()] * 64
    cases = [("phase 6", MicwDecodePlan(cs._post_batch(dev)[0], dev)),
             ("phase 8 tiles", rgb_device._stage(tiles, dev)[1])]
    for case, plan in cases:
        outs = cs._entropy_outputs(plan)
        groups = [(outs[k], *g) for k, g in zip(plan._post_keys, plan._post_groups)]
        subsets = [("launch", groups)] + [
            (kind, [g for g in groups if g[2]["predictor"] in preds])
            for kind, preds in KINDS.items()]
        for label, sub in subsets:
            if not sub:
                continue
            pk = post.PostPacking([(m, kw) for _e, m, kw in sub], dev)
            ents = [post._entropy_rows(e, S, dev, g)
                    for g, ((e, _m, _kw), S) in enumerate(zip(sub, pk.rows))]
            wants = {stage: _stage_plain(sub, stage) for stage in {s for _d, s in builds.values()}
                     if stage in CHECKED}
            pixels = sum(m.shape[0] * kw["width"] * kw["strip_h"] for _e, m, kw in sub)
            for name, (_d, stage) in builds.items():
                got = post._post_launch(pk, ents, libs[name])
                torch.cuda.synchronize()
                if stage in CHECKED and not all(torch.equal(g, w)
                                                for g, w in zip(got, wants[stage])):
                    raise AssertionError(f"{case} {label} {name}: outputs differ from the plain "
                                         f"twin's (stage {stage})")
            best = dict.fromkeys(builds, float("inf"))
            for order in (list(builds), list(builds)[::-1]):
                for name in order:
                    lib = libs[name]
                    best[name] = min(best[name], _device_ms(
                        lambda: post._post_launch(pk, ents, lib), args.reps))
            for name, (_d, stage) in builds.items():
                checked = "equal" if stage in CHECKED else "unchecked"
                summary["design_points"].append({"case": case, "subset": label, "form": name,
                                                 "ms": best[name], "strips": len(pk.blocks),
                                                 "pixels": pixels, "checked": checked})
                print(f"{case:14s} {label:8s} {name:10s} {best[name]:8.3f} ms  "
                      f"{len(pk.blocks):5d} strips, {pixels} pixels, {len(pk.parts)} launch(es) "
                      f"({checked})", flush=True)
            del got, wants
        del outs, groups
    for name, (defines, _stage) in builds.items():
        smem, occ, regs = post._launch_shape(libs[name])
        summary["shapes"][name] = [smem, occ, regs]
        print(f"shape {name}: {smem} bytes of shared memory a block, {occ} blocks an SM, "
              f"{regs} registers a thread")
        for ln in _ptxas_lines(defines):
            print(f"ptxas {name}: {ln}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
