#!/usr/bin/env python3
"""Times the r-mode decode kernel's design points on the card, one by one.

    python3 scripts/rle_design_points.py [--reps N]

Stages ``chip_smoke.py``'s r-mode batch (phase 5: 1728 strips of 512x128
in 14 buckets, both entropy families) and times ``csrc/rans_rle.cu`` in
other forms, built with the source's ``MIC_RLE_*`` macros into libraries
of their own, and in other launch shapes with the default build.

Forms (all buckets in one launch):

* ``default``: the design: step counts by warp votes, words from the
  shared ring, run tables in shared memory, the expand picked per strip by
  the honesty test (every strip of this batch passes it: parallel);
* ``serial``: the default build with the serial expand forced (one row a
  step: two windowed searches, a barrier and, for zzr / pdr, a block scan
  per row), i.e. the old expand behind the new entropy step;
* ``parallel``: the default build with the parallel expand forced;
* ``noring``: the words read from device memory after the count
  (``MIC_RLE_RING=0``);
* ``entropy`` / ``tables``: the default stopped after phase 1 / 1.5
  (``MIC_RLE_STOP=1`` / ``2``): a split of the time, outputs not compared.

Launch shapes: ``one`` (the plan's launch) and ``alone`` (the first 132
strips of the longest bucket, one a streaming multiprocessor: a strip's
chain with its SM to itself) for every form, and with the default build
``buckets`` (one launch per bucket, one after another, as the plan ran
before: 14) and ``families`` (one launch per entropy family: 2).

Per form or shape: milliseconds per launch and per plan (CUDA events, mean
of ``--reps`` after a warm-up) and nanoseconds per chain iteration, where
a strip's chain is its entropy steps plus its expand rows (the longest:
256 + 512).  Every output but the stopped forms' must equal the plan's.
Then ``plan.run()``, each wrapper's buckets one call after another, timed
three ways: through the wrapper (``b.fn(*b.ops, **b.kwargs)``, which keeps
its last packing, as ``chip_smoke.py`` phase 2 times rows 4 and 5), with
a packing built and copied to the card every call (a wrapper's first call
on new tensors), and as bare launches of packings built beforehand; then
the share of strips that pass the honesty test and a JSON summary.
Another commit's tree is compared with ``scripts/compare_trees.py``.
Needs an NVIDIA GPU and nvcc.  Imports neither jax nor anything of
mic_tpu.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# name, -D flags, expand form, outputs compared
FORMS = [("default", (), "auto", True), ("serial", (), "serial", True),
         ("parallel", (), "parallel", True), ("noring", ("-DMIC_RLE_RING=0",), "auto", True),
         ("entropy", ("-DMIC_RLE_STOP=1",), "auto", False),
         ("tables", ("-DMIC_RLE_STOP=2",), "auto", False)]
SMS = 132  # the H100 SXM's streaming multiprocessors

def main() -> int:
    import torch

    import chip_smoke as cs
    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch._build import kernel_library
    from mic_tpu_torch.tpu import rans_decode as rd

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rle_design_points: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    summary = {"design_points": []}

    plan = MicwDecodePlan(cs._r_batch()[0], dev)
    groups = plan._rle_groups
    want = rd.rans_decode_rle_groups(groups, plan.rle_packing)
    torch.cuda.synchronize()
    chain = max(kw["steps"] + kw["out_rows"] for _fn, _ops, kw in groups)

    def measure(form, label, launches, lib, expand="auto", compare=True, chain=chain):
        """``launches``: (packing, the plan's outputs it must give); timed
        one after another as one plan."""
        for packing, expect in launches:
            got = rd._rle_launch(packing, expand, lib)
            torch.cuda.synchronize()
            if compare and not all(torch.equal(g, w) for g, w in zip(got, expect)):
                raise AssertionError(f"{form} {label}: outputs differ from the plan's")

        def run():
            for packing, _idx in launches:
                rd._rle_launch(packing, expand, lib)

        ms = cs._cuda_ms(run, args.reps)
        summary["design_points"].append({"form": form, "launch": label, "launches": len(launches),
                                         "ms_per_plan": ms, "ms_per_launch": ms / len(launches),
                                         "ns_per_chain_iteration": ms * 1e6 / chain})
        print(f"{form:9s} {label:9s} {len(launches):2d} launch(es): {ms:7.3f} ms per plan, "
              f"{ms / len(launches):7.3f} ms per launch, {ms * 1e6 / chain:7.1f} ns per chain "
              f"iteration ({chain})")

    one = [(plan.rle_packing, want)]
    longest = max(range(len(groups)),
                  key=lambda i: (groups[i][2]["steps"], groups[i][1][0].shape[0]))
    fn, ops, kw = groups[longest]
    n = min(SMS, ops[0].shape[0])
    alone = [(rd.RlePacking([(fn, tuple(o[:n] for o in ops), kw)]), [want[longest][:n]])]
    for form, defines, expand, compare in FORMS:
        lib = kernel_library(defines)
        measure(form, "one", one, lib, expand, compare)
        measure(form, "alone", alone, lib, expand, compare, chain=kw["steps"] + kw["out_rows"])
    lib = kernel_library()
    buckets = [(rd.RlePacking([g]), [want[i]]) for i, g in enumerate(groups)]
    measure("default", "buckets", buckets, lib)
    fams = {}
    for i, g in enumerate(groups):
        fams.setdefault(g[0], []).append(i)
    measure("default", "families", [(rd.RlePacking([groups[i] for i in idx]),
                                      [want[i] for i in idx]) for idx in fams.values()], lib)
    run_ms = cs._cuda_ms(plan.run, args.reps)
    print(f"plan.run(): {run_ms:.3f} ms (the r-launch and pdr's column prefix sums)")
    summary["plan_run_ms"] = run_ms
    for name in ("rans_decode_rle", "rans_decode_rle_alias"):
        mine = [(p, g) for (p, _w), g in zip(buckets, groups) if g[0].__name__ == name]
        wrap = sum(cs._cuda_ms(lambda: g[0](*g[1], **g[2]), args.reps) for _p, g in mine)
        fresh = sum(cs._cuda_ms(lambda: rd._rle_launch(rd.RlePacking([g]), "auto", lib),
                                args.reps) for _p, g in mine)
        bare = sum(cs._cuda_ms(lambda: rd._rle_launch(p, "auto", lib), args.reps)
                   for p, _g in mine)
        summary[f"{name}_bucket_sum_ms"] = {"wrapper": wrap, "packing_each_call": fresh,
                                            "bare_launch": bare}
        print(f"{name}: its buckets one call after another: {wrap:.3f} ms through the wrapper, "
              f"{fresh:.3f} ms with a packing built every call, {bare:.3f} ms as bare "
              f"launches of packings built beforehand")

    honest = total = 0
    for fn, ops, kw in groups:
        if fn is rd.rans_decode_rle:
            syms = torch.cat(list(rd._packed_symbols(*ops[:6], kw["steps"])), dim=1)
        else:
            syms = torch.cat(list(rd._alias_symbols(*ops[:9], kw["steps"], kw["esc"])), dim=1)
            syms &= 0xFFFF
        ok = rd.rle_honest(syms, ops[-2], ops[-1], steps=kw["steps"], maxr=kw["maxr"],
                           dense=kw["dense"])
        honest += int(ok.sum())
        total += ok.numel()
    summary["honest_strips"] = [honest, total]
    print(f"strips passing the honesty test (parallel expand): {honest} of {total}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
