#!/usr/bin/env python3
"""Times the tANS decode kernel's design points on the card, one by one.

    python3 scripts/tans_design_points.py [--reps N]

Stages ``chip_smoke.py``'s reference archive batch (phase 7: 1537 kernel
streams in four groups) and times ``csrc/tans_decode.cu`` in other forms
of its step, built with the source's ``MIC_TANS_*`` macros into libraries
of their own, and other shapes of its launch with the default build.

Forms of the step (each stream's own sizes, 4 warps a block, one block
per SM):

* ``ring``: every row takes the general form: range checks, active tests
  and two ring words through the window's clamp per state;
* ``pipe0``: hot rows (the bits below the cursor in registers, no clamp,
  no range check), the window's words loaded by the step that uses them;
* ``pipe8``: hot rows with the window's words loaded a step ahead at
  every N;
* ``regs``: the default build: a step ahead at N = 2 only.

Shapes of the launch (default build):

* ``one``: one stream a block (every stream on the first warp scheduler
  of its SM) at the launch's widest table and alphabet, the shape before
  the redesign;
* ``most``: each stream's own sizes, up to 8 streams a block, the pool
  under which an SM holds the most streams;
* ``four``: own sizes, 4 streams a block, one block per SM: a stream per
  scheduler (``TansPacking``'s default).

Every form and shape runs each group alone and all groups in one launch
(``one launch``).  Per launch: milliseconds (CUDA events, mean of
``--reps`` launches after a warm-up), nanoseconds per step of its longest
chain, and the blocks an SM holds
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) times the streams a
block holds.  Every output must equal the plan's.  Last come the plan's
own launch and a JSON summary.  Needs an NVIDIA GPU
and nvcc.  Imports neither jax nor anything of mic_tpu.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# name, MIC_TANS_HOT, MIC_TANS_PIPE_MAX_N
FORMS = [("ring", 0, 2), ("pipe0", 1, 0), ("pipe8", 1, 8), ("regs", 1, 2)]
SM_SHARED_BYTES = 233472  # an SM's shared memory; every resident block reserves 1 KB of it


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from mic_tpu_torch._build import kernel_library
    from mic_tpu_torch.tpu import tans_decode as td

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tans_design_points: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    batch, _host, _work = cs._ref_batch()
    plan = td.TansDecodePlan(batch, dev)
    groups = plan._launch_groups
    chains = [max(-(-c // kw["n_states"]) for c in counts)
              for _idx, counts, _ops, kw in plan.groups]
    want = plan.run()
    torch.cuda.synchronize()
    summary = []

    def measure(form, lib, packings):
        """One launch per packing; per launch: ms, ns per step of its
        longest chain, streams an SM holds."""
        for packing, label, chain, expect in packings:
            got = td._launch(packing, lib)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, expect)):
                raise AssertionError(f"{form} {label}: outputs differ from the plan's")
            ms = cs._cuda_ms(lambda: td._launch(packing, lib), args.reps)
            per_sm = lib.mic_tans_occupancy(packing.warps, packing.pool_bytes)
            per_block = max(len(b[1]) for b in packing.blocks)
            summary.append({"form": form, "launch": label, "ms": ms,
                            "ns_per_step": ms * 1e6 / chain, "blocks_per_sm": per_sm,
                            "streams_per_block": per_block, "pool_bytes": packing.pool_bytes,
                            "blocks": len(packing.blocks), "warps": packing.warps})
            print(f"{form:6s} {label:9s} {ms:7.3f} ms {ms * 1e6 / chain:6.1f} ns/step of "
                  f"{chain} steps; {len(packing.blocks)} blocks x {packing.warps} warps, "
                  f"pool {packing.pool_bytes} B, an SM holds {per_sm} x up to "
                  f"{per_block} streams")

    def launches(make):
        """The four groups alone and all together, each packed by
        ``make(groups)``."""
        out = [(make([g]), f"N={g[2]['n_states']}/{g[0][0].shape[0]}", chain, [o])
               for g, chain, o in zip(groups, chains, want)]
        return out + [(make(groups), f"all/{plan.stats['kernel']}", max(chains), want)]

    def four(gs):
        return td.TansPacking(gs)

    def most(gs):
        # Of the pools that let 1 to 8 blocks share an SM, the one under
        # which an SM holds the most streams (ties: the smaller blocks).
        best = None
        for per_sm in range(1, 9):
            pool = min((SM_SHARED_BYTES // per_sm - 1024) // 16 * 16, td.MAX_POOL_BYTES)
            try:
                packing = td.TansPacking(gs, warps=td.MAX_WARPS, pool_bytes=pool)
            except ValueError:  # a stream needs more than this pool
                break
            held = per_sm * sum(len(b[1]) for b in packing.blocks) / len(packing.blocks)
            if best is None or held >= best[0]:
                best = (held, packing)
        return best[1]

    def one(gs):
        wide = [(ops, None, kw) for ops, _sz, kw in gs]
        need = max(4 * (ops[3].shape[1] + ops[4].shape[1]) for ops, _sz, _kw in gs)
        return td.TansPacking(wide, warps=1, pool_bytes=need + td.STREAM_FIXED_BYTES)

    roomy = launches(four)
    for form, hot, pipe_n in FORMS:
        lib = kernel_library(() if form == "regs" else (f"-DMIC_TANS_HOT={hot}",
                                                        f"-DMIC_TANS_PIPE_MAX_N={pipe_n}"))
        measure(form, lib, roomy)
    lib = kernel_library()
    measure("one", lib, launches(one))
    measure("most", lib, launches(most))
    measure("four", lib, roomy)
    measure("plan", lib, [(plan.packing, f"all/{plan.stats['kernel']}", max(chains), want)])
    print("tableLog histogram of the kernel streams:", plan.stats["table_logs"])
    sizes = np.concatenate([s.cpu().numpy() for s in plan.sizes])
    need = td.stream_bytes(sizes)
    print(f"shared memory a stream: {int(need.min())}-{int(need.max())} bytes, "
          f"mean {float(need.mean()):.0f}")
    print(json.dumps({"design_points": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
