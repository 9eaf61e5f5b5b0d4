#!/usr/bin/env python3
"""Runs some of ``chip_smoke.py``'s phases in two trees of this repository
on one card, each run in a process of its own, in the order other, this,
this, other.

    python3 scripts/compare_trees.py DIR [--phases 2r,5,6,8] [--reps N]

``DIR`` is an unpacked copy of another commit (for example the parent:
``git archive HEAD | tar -x -C build/parent``).  Each run imports the
``chip_smoke.py`` and ``mic_tpu_torch`` of its own tree, builds that
tree's kernels, and runs the phases with that tree's functions, so both
sides are measured by the same code as far as the trees share it:

* ``2r``: each r-mode bucket of phase 5's batch through its one-bucket
  wrapper (``b.fn(*b.ops, **b.kwargs)``, the call phase 2 times for PERF.md
  rows 4 and 5), CUDA events, mean of ``--reps`` after a warm-up, summed
  per wrapper;
* ``5``, ``6``, ``8``: the tree's own phase function (r-mode plan, post
  path, RGB / WSI containers), which verifies its outputs and prints its
  times.

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
KEEP = (" ms per ", "GB/s", "idle_share", "r-wrapper")

RUN = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from mic_tpu_torch._build import kernel_library
dev = torch.device("cuda", 0)
kernel_library()
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
if "5" in phases:
    cs._rle_phase(dev)
if "6" in phases:
    cs._post_phase(dev, *cs._post_batch(dev))
if "8" in phases:
    cs._rgb_wsi_phase(dev, cs._slide()[0])
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
