#!/usr/bin/env python3
"""Times the scan tier's lanes kernel in its design points on the card.

    python3 scripts/lanes_design_points.py [--reps N] [--only cell]

Builds ``csrc/rans_lanes.cu``'s other forms with its ``MIC_LANES_*``
macros into libraries of their own and times each on the same operands:

* ``default``: the warp form as shipped (a warp a strip, 4 a block, the
  words from a ``cp.async`` ring, U = 4 steps a batch where U * LPT <= 16,
  FF 41 strips' 128-bucket alias tables in shared memory, every other
  table read from device memory through L1);
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
(the plan: the default build's).

The cell's shape (``--only cell`` runs this part alone): the benchmark's
CT slice (``portbench/data``) as 8-lane FF 41 containers (auto-fast, the
``ct_scan8`` cell's mix: four strips a slice at tableLog 12), 16 rolled
variants copied to 528 and 768 distinct containers (2,112 strips, the
warp form's residency at 4 blocks an SM, and 3,072, the largest study:
two waves), so that each strip has tables of its own as in a study.  One
plan each; its launch with the bucket tables (``buckets``) against the
same groups' first ten operands (``slot tables``: every strip reads its
24 KB of slot tables through L1 and L2), outputs equal, each launch's
shape (``_launch_shape``: shared bytes a block, blocks an SM, registers)
beside its ns a step (ms / 8,192 steps); in each build of the list
above (the default build's alone with ``--only cell``).

Milliseconds from CUDA events, mean of ``--reps`` after a warm-up; then a
JSON summary.  Needs an NVIDIA GPU and nvcc.  Imports neither jax nor
anything of mic_tpu.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BUILDS = {"default": (), "noring": ("-DMIC_LANES_RING=0",), "u1": ("-DMIC_LANES_U=1",),
          "u2": ("-DMIC_LANES_U=2",), "u8": ("-DMIC_LANES_U=8",)}
LANES = (64, 128, 256, 512)
STRIPS = 132  # one per SM
CELL_SLICES = (528, 768)  # 2,112 strips (one wave at 4 blocks an SM) and a 768-slice study
CELL_VARIANTS = 16


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
    ap.add_argument("--only", choices=["cell"], default=None,
                    help="run the cell's shape alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lanes_design_points: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    summary = {"design_points": []}
    libs = {name: kernel_library(defines) for name, defines in BUILDS.items()
            if name == "default" or args.only != "cell"}
    summary["cell"] = _cell_shape(dev, args.reps, libs)
    if args.only == "cell":
        print(json.dumps(summary))
        return 0

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


def _cell_shape(dev, reps: int, libs: dict) -> list:
    """The ``ct_scan8`` cell's strips in the bucket-table and slot-table
    front ends, in each of ``libs`` (the module's docstring); returns one
    entry a case."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from mic_tpu_torch import MicwDecodePlan, micw_compress
    from mic_tpu_torch.tpu import scan_decode as sd

    root = Path(__file__).resolve().parent.parent
    px = np.fromfile(root / "portbench" / "data" / "CT_512_512_image.raw", dtype="<u2")
    img = px.reshape(512, 512)
    variants, pixels = [], []
    for i in range(CELL_VARIANTS):
        v = np.ascontiguousarray(np.roll(img, (4 * i, 7 * i), axis=(0, 1))).ravel()
        pixels.append(v)
        variants.append(micw_compress(v, 512, 512, int(v.max()), lanes=8,
                                      predictor="auto-fast", entropy="alias"))
    out = []
    for n in CELL_SLICES:
        blobs = [bytes(bytearray(variants[i % CELL_VARIANTS])) for i in range(n)]
        plan = MicwDecodePlan(blobs, dev, scan=True)
        mism = plan.verify_batch(plan.run(), [pixels[i % CELL_VARIANTS] for i in range(n)])
        if mism:
            raise AssertionError(f"cell shape, {n} slices: {mism} mismatches")
        groups = plan._scan_groups
        strips = sum(ops[0].shape[0] for _f, ops, _k in groups)
        tls = sorted({int(t) for _f, ops, _k in groups for t in ops[6].cpu()})
        args_ = plan.scan_packing.desc["arg"]
        chain = int(np.minimum(args_[:, 3], args_[:, 6]).max())
        want = sd._lanes_launch(plan.scan_packing)
        slots = sd.LanesPacking([(fn, ops[:10], kw) for fn, ops, kw in groups])
        for (name, lib), (form, pk) in itertools.product(
                libs.items(), (("buckets", plan.scan_packing), ("slot tables", slots))):
            got = sd._lanes_launch(pk, lib)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"cell shape, {n} slices, {name} {form}: outputs differ")
            ms = cs._cuda_ms(lambda: sd._lanes_launch(pk, lib), reps)
            smem, per_sm, regs = sd._launch_shape(pk, lib=lib)
            form = f"{name} {form}"
            entry = {"case": f"ct_scan8 shape, {n} slices", "form": form, "strips": strips,
                     "tls": tls, "ms": ms, "ns_per_step": ms * 1e6 / chain,
                     "smem_bytes": smem, "blocks_per_sm": per_sm, "registers": regs,
                     "blocks": len(pk.teams)}
            out.append(entry)
            print(f"{entry['case']:28s} {form:20s} {ms:8.3f} ms {ms * 1e6 / chain:8.1f} ns a "
                  f"step ({strips} strips, tl {tls}, {chain} steps; {len(pk.teams)} blocks, "
                  f"{smem} bytes of shared memory a block, {per_sm} blocks an SM, {regs} "
                  f"registers)", flush=True)
        del plan, want, got, slots
    return out


if __name__ == "__main__":
    sys.exit(main())
