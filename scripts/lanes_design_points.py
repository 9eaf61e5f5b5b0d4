#!/usr/bin/env python3
"""Times the scan tier's lanes kernel in its design points on the card.

    python3 scripts/lanes_design_points.py [--reps N]

Builds ``csrc/rans_lanes.cu``'s other forms with its ``MIC_LANES_*``
macros into libraries of their own and times each on the same operands:

* ``default``: the warp form as shipped (a warp a strip, 4 a block, the
  words from a ``cp.async`` ring, U = 4 steps a batch where U * LPT <= 16,
  tables read from device memory through L1);
* ``noring``: the words read from device memory after the count
  (``MIC_LANES_RING=0``);
* ``u1`` / ``u2`` / ``u8``: 1, 2 or 8 steps a batch (``MIC_LANES_U``; U *
  LPT <= 16 still caps it);
* ``block``: every strip in the block form (a block a strip, a thread a
  lane, two named barriers a step; ``warp_lanes=0``), symbols out; and
  ``block+post``, that launch followed by the post kernel
  (``post.post_decode``) the plan would run on its symbols: what a bucket
  past ``WARP_LANES`` costs.

Operands: CT_dev encoded by the port's host encoder at 64, 128, 256 and
512 lanes (zzd, FF 57: one scan bucket of 4 strips, replicated to 132 strips,
33 blocks of 4 in the warp form, so each strip has an SM's scheduler to
itself; ns a step = ms / the strips' steps), symbols out and with the zzd
inverse fused; then ``chip_smoke.py``'s phase 10 batch (1792 strips, 13
buckets) in the plan's launch.  Every output must equal the plain twin's
(the plan: the default build's).  Milliseconds from CUDA events, mean of
``--reps`` after a warm-up; then a JSON summary.  Needs an NVIDIA GPU and
nvcc.  Imports neither jax nor anything of mic_tpu.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BUILDS = {"default": (), "noring": ("-DMIC_LANES_RING=0",), "u1": ("-DMIC_LANES_U=1",),
          "u2": ("-DMIC_LANES_U=2",), "u8": ("-DMIC_LANES_U=8",)}
LANES = (64, 128, 256, 512)
STRIPS = 132  # one per SM


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from mic_tpu_torch import MicwDecodePlan, micw_compress
    from mic_tpu_torch._build import kernel_library
    from mic_tpu_torch.tpu import post
    from mic_tpu_torch.tpu import scan_decode as sd

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lanes_design_points: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    libs = {name: kernel_library(defines) for name, defines in BUILDS.items()}
    summary = {"design_points": []}

    def measure(label, form, groups, want, chain, lib, **packing):
        pk = sd.LanesPacking(groups, **packing)
        got = sd._lanes_launch(pk, lib)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{label} {form}: outputs differ from the plain twin's")
        ms = cs._cuda_ms(lambda: sd._lanes_launch(pk, lib), args.reps)
        summary["design_points"].append({"case": label, "form": form, "ms": ms,
                                         "ns_per_step": ms * 1e6 / chain,
                                         "smem_bytes": pk.smem_bytes})
        print(f"{label:34s} {form:14s} {ms:8.3f} ms {ms * 1e6 / chain:8.1f} ns a step "
              f"({chain} steps; {pk.n_launches} launch(es), {pk.smem_bytes} bytes of shared "
              f"memory a warp-form block)", flush=True)

    def block_post(label, group, want, kw, chain, lib):
        """The block form's launch, then the post kernel on its symbols."""
        pk = sd.LanesPacking([group], warp_lanes=0)
        meta = torch.zeros((group[1][0].shape[0], 3), dtype=torch.int64, device=dev)
        post_kw = dict(width=kw["width"], strip_h=kw["strip_h"], max_runs=128, max_tokens=128,
                       mid_count=0, delim=0, predictor=kw["inverse"])
        post_pk = post.PostPacking([(meta, post_kw)], dev)

        def run():
            (sym,) = sd._lanes_launch(pk, lib)
            return post.post_decode_groups([(sym, meta, post_kw)], post_pk)[0]

        if not torch.equal(run(), want):
            raise AssertionError(f"{label} block+post: pixels differ from the plain twin's")
        ms = cs._cuda_ms(run, args.reps)
        summary["design_points"].append({"case": label, "form": "block+post", "ms": ms,
                                         "ns_per_step": ms * 1e6 / chain})
        print(f"{label:34s} {'block+post':14s} {ms:8.3f} ms {ms * 1e6 / chain:8.1f} ns a step "
              f"(the block form's launch, then the post kernel)", flush=True)

    ct = np.fromfile(cs.TESTDATA / "CT_dev.raw", dtype="<u2")
    for lanes in LANES:
        blob = micw_compress(ct, 512, 512, int(ct.max()), lanes=lanes, predictor="zzd")
        plan = MicwDecodePlan([blob] * (STRIPS // 4), dev, scan=True)
        (key,) = plan._scan_keys
        fn, ops, kw = plan.buckets[key].launch  # fused: zzd at 512 pixels a row
        sym_kw = {"steps": kw["steps"]}
        sym = sd.rans_decode_lanes_plain(*ops, **sym_kw)
        fused = sd._inverse_plain(sym, "zzd", kw["width"], kw["strip_h"])
        label = f"CT_dev zzd, {lanes} lanes x{ops[0].shape[0]}"
        steps = kw["steps"]
        for name, lib in libs.items():
            measure(label, f"{name} fused", [(fn, ops, kw)], [fused], steps, lib)
            if name == "default":
                measure(label, "default syms", [(fn, ops, sym_kw)], [sym], steps, lib)
                measure(label, "block syms", [(fn, ops, sym_kw)], [sym], steps, lib,
                        warp_lanes=0)
                block_post(label, (fn, ops, sym_kw), fused, kw, steps, lib)
        del plan
    blobs, _expected, _names = cs._scan_batch()
    plan = MicwDecodePlan(blobs, dev)
    groups = plan._scan_groups
    want = sd._lanes_launch(plan.scan_packing, libs["default"])
    args_ = plan.scan_packing.desc["arg"]
    chain = int(np.minimum(args_[:, 3], args_[:, 6]).max())
    label = f"phase 10, {sum(o[0].shape[0] for _f, o, _k in groups)} strips"
    for name, lib in libs.items():
        measure(label, f"{name} fused", groups, want, chain, lib)
    syms = sd.rans_decode_lanes_groups_plain(cs._symbols_out(groups))
    measure(label, "default syms", cs._symbols_out(groups), syms, chain, libs["default"])
    measure(label, "block syms", cs._symbols_out(groups), syms, chain, libs["default"],
            warp_lanes=0)
    summary["plan_run_ms"] = cs._cuda_ms(plan.run, args.reps)
    print(f"phase 10 plan.run(): {summary['plan_run_ms']:.3f} ms")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
