#!/usr/bin/env python3
"""Times the direct-mode decode kernel's design points on the card, one by one.

    python3 scripts/direct_design_points.py [--reps N] [--parts direct,post]

Stages ``chip_smoke.py``'s decode batch (phase 3: 1408 strips in 9
buckets, zzd / vdd / pdd on both entropy families) and times
``csrc/rans_direct.cu`` in other forms, built with the source's
``MIC_DIRECT_*`` macros into libraries of their own, and in other launch
shapes with the default build.

Forms:

* ``contiguous`` (the default): a warp per strip, thread j holding lanes
  4j..4j+3;
* ``strided``: thread j holding lanes j, j+32, j+64, j+96
  (``MIC_DIRECT_LAYOUT=1``);
* ``block128``: 128 threads per strip, one lane a thread, the counts and
  the row scan through a named barrier (``MIC_DIRECT_TEAM=128``);
* ``noring``: the words read from device memory after the count
  (``MIC_DIRECT_RING=0``).

Shapes: ``one`` (the plan's launch) and ``alone`` (the first 132 strips of
each bucket, one a block and so one an SM: a strip's chain with its SM to
itself; ns per step = ms / the bucket's steps) for every form, and with
the default build ``buckets`` (one launch per bucket, one after another,
as the plan ran before: 9), ``least_load`` (each strip, longest chain
first, into the block with the least work, not 4 consecutive ones a
block), ``one_a_block`` (one strip a block) and ``pdd_cumsum`` (the plan's
launch without pdd's column sum, then ``torch.cumsum`` on each pdd bucket
as the plan did before).  Every output must equal the plan's
(``pdd_cumsum``: the plan's pdd pixels).  Then ``plan.run()``.

Post part (``--parts post``): the post path's symbols-out groups of
``chip_smoke.py``'s phase 6 batch (1248 strips, 15 groups: packed symbols,
two tables at tl 13, FF 41 symbols, two direct buckets) with the default
build: ``one`` (the plan's launch: 4 consecutive strips a block for
every group, one budget for the launch, so the tl 13 blocks take 213 KB
and every block has an SM to itself) against ``buckets`` (one launch per
group), ``per_group`` (strips a block per group within the packed and FF
41 strips' largest block: the tl 13 strips one a block, 3 blocks an SM)
and ``one_device_tables`` (the two-table groups read from device memory,
``rans_decode._tables_from_memory``); alone (each post group's first 132 strips, one a block):
the packed front end with no inverse, FF 41 symbols, and the two tables
staged and from device memory at tl 13, and CT_dev_1strip_tl15 x32 (tl
15, 2048 steps) staged and from device memory.  Then a JSON summary.  Milliseconds from
CUDA events, mean of ``--reps`` after a warm-up.  Needs an NVIDIA GPU and
nvcc.  Imports neither jax nor anything of mic_tpu.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FORMS = [("contiguous", ()), ("strided", ("-DMIC_DIRECT_LAYOUT=1",)),
         ("block128", ("-DMIC_DIRECT_TEAM=128",)), ("noring", ("-DMIC_DIRECT_RING=0",))]
SMS = 132  # the H100 SXM's streaming multiprocessors


def _least_load(rd, groups):
    """The plan's packing with its blocks refilled another way: strips
    longest chain first, each into the block with the least work that has
    room (so every block carries about equal work, and mixes groups),
    against the default's 4 consecutive strips a block."""
    import heapq

    import numpy as np

    pk = rd.DirectPacking(groups)
    teams = pk.blocks.reshape(-1, 4)
    live = teams[teams[:, 0] >= 0]  # longest chain first
    steps = np.array([kw["steps"] for _f, _o, kw in groups])
    n = len(pk.blocks)
    load = [(0, b) for b in range(n)]
    members = [[] for _ in range(n)]
    for i in range(len(live)):
        work, b = heapq.heappop(load)
        members[b].append(i)
        if len(members[b]) < 4:
            heapq.heappush(load, (work + int(steps[live[i, 0]]), b))
    members.sort(key=lambda m: -int(steps[live[m[0], 0]]))
    blocks = np.full((n, 4, 4), -1, np.int32)
    used = 0
    for b, m in enumerate(members):
        need = np.asarray(pk.strip_words, np.int64)[live[m, 0]]
        blocks[b, :len(m), :2] = live[m, :2]
        blocks[b, :len(m), 2], blocks[b, :len(m), 3] = np.cumsum(need) - need, 0
        used = max(used, int(need.sum()))
    pk.blocks, pk.smem_bytes = blocks, 4 * used
    pk.gdesc, pk.bdesc = pk._upload(pk.desc, pk.blocks)
    return pk


def _per_group(rd, groups):
    """The plan's packing with strips a block chosen per group: the budget
    is the largest block of 4 consecutive packed or FF 41 strips, and a
    two-table strip joins a block only while it stays within it (at tl
    13, one strip a block), so no block outgrows the others; against the
    plan's one rule for the launch.  For groups whose strips all fit that
    budget (phase 6's)."""
    import numpy as np

    pk = rd.DirectPacking(groups)
    sw = np.asarray(pk.strip_words, np.int64)
    teams = pk.blocks.reshape(-1, 4)
    live = teams[teams[:, 0] >= 0]  # longest chain first
    two = np.array([fn is rd.rans_decode for fn, _o, _k in groups])
    usual = live[~two[live[:, 0]], 0]
    budget = int(np.add.reduceat(sw[usual], np.arange(0, usual.size, 4)).max())
    cap = np.where(two, np.minimum(4, budget // sw), 4)
    if (cap == 0).any():
        raise ValueError("a two-table strip fits no block of the budget")
    members, mine, used, room = [], [], 0, 4
    for g, st in live[:, :2]:
        if mine and (len(mine) >= min(room, cap[g]) or used + sw[g] > budget):
            members.append(mine)
            mine, used, room = [], 0, 4
        mine.append((g, st, used))
        used, room = used + int(sw[g]), min(room, int(cap[g]))
    members.append(mine)
    blocks = np.full((len(members), 4, 4), -1, np.int32)
    for b, m in enumerate(members):
        blocks[b, :len(m), :3] = m
        blocks[b, :len(m), 3] = 0
    pk.blocks = blocks
    pk.smem_bytes = 4 * max(sum(int(sw[g]) for g, _s, _o in m) for m in members)
    pk.gdesc, pk.bdesc = pk._upload(pk.desc, pk.blocks)
    return pk


def _post_points(cs, rd, dev, reps, summary) -> None:
    """The post part: phase 6's symbols-out groups in one launch and in
    other shapes, each front end alone, two tables staged and not."""
    import torch

    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch._build import kernel_library

    lib = kernel_library()
    plan = MicwDecodePlan(cs._post_batch(dev)[0], dev)
    groups, packing = plan._direct_groups, plan.direct_packing
    want = rd._direct_launch(packing)
    torch.cuda.synchronize()
    longest = max(kw["steps"] for _fn, _ops, kw in groups)

    def measure(label, launches, chain):
        for pk, expect in launches:
            got = rd._direct_launch(pk, lib)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, expect)):
                raise AssertionError(f"post {label}: outputs differ from the plan's")
        ms = cs._cuda_ms(lambda: [rd._direct_launch(pk, lib) for pk, _w in launches], reps)
        occ = lib.mic_direct_occupancy(max(pk.smem_bytes for pk, _w in launches))
        summary["design_points"].append({"form": "post", "launch": label,
                                         "launches": len(launches), "ms": ms,
                                         "ns_per_step": ms * 1e6 / chain,
                                         "blocks_per_sm": occ})
        print(f"post {label:44s} {len(launches)} launch(es): "
              f"{ms:7.3f} ms, {ms * 1e6 / chain:7.1f} ns per step of the longest chain "
              f"({chain}), {occ} blocks an SM at the largest block", flush=True)

    print(f"post: {len(groups)} groups, {sum(o[0].shape[0] for _f, o, _k in groups)} strips; "
          f"{cs._launches(packing)}")
    measure("one", [(packing, want)], longest)
    measure("buckets", [(rd.DirectPacking([g]), [w]) for g, w in zip(groups, want)], longest)
    per_group = _per_group(rd, groups)
    print(f"post per_group: {cs._launches(per_group)}")
    measure("per_group", [(per_group, want)], longest)
    measure("one_device_tables", [(rd._tables_from_memory(rd.DirectPacking(groups)), want)],
            longest)
    for (fn, ops, kw), w in zip(groups, want):
        if fn not in (rd.rans_decode_packed, rd.rans_decode, rd.rans_decode_alias):
            continue
        n = min(SMS, ops[0].shape[0])
        sub = (fn, tuple(o[:n] for o in ops), kw)
        label = f"alone {fn.__name__[12:] or 'two_table'} steps {kw['steps']} x{n}"
        stages = (True, False) if fn is rd.rans_decode else (True,)
        for stage in stages:
            pk = rd.DirectPacking([sub], per_block=1)
            if not stage:
                rd._tables_from_memory(pk)
            measure(label + ("" if stage else " device tables"), [(pk, [w[:n]])], kw["steps"])
    tl15 = MicwDecodePlan([cs.CT_TL15.read_bytes()] * 32, dev)
    (g15,) = tl15._direct_groups
    w15 = rd._direct_launch(tl15.direct_packing)
    for stage in (True, False):
        pk = rd.DirectPacking([g15])
        if not stage:
            rd._tables_from_memory(pk)
        print(f"post tl 15 x32: {cs._launches(pk)}")
        measure(f"alone two_table tl 15 x32{'' if stage else ' device tables'}", [(pk, w15)],
                g15[2]["steps"])
    summary["post_plan_run_ms"] = cs._cuda_ms(plan.run, reps)
    print(f"post plan.run(): {summary['post_plan_run_ms']:.3f} ms (launch and torch post ops)")


def main() -> int:
    import torch

    import chip_smoke as cs
    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch._build import kernel_library
    from mic_tpu_torch.tpu import rans_decode as rd

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parts", default="direct,post")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        print("direct_design_points: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    summary = {"design_points": []}
    if "post" in parts:
        _post_points(cs, rd, dev, args.reps, summary)
    if "direct" not in parts:
        print(json.dumps(summary))
        return 0
    names = [k for k, v in cs.BATCH.items() for _ in range(v[2])]
    blobs = {k: v[0].read_bytes() for k, v in cs.BATCH.items()}
    plan = MicwDecodePlan([blobs[k] for k in names], dev)
    groups, packing = plan._direct_groups, plan.direct_packing
    want = rd.rans_decode_direct_groups(groups, packing)
    torch.cuda.synchronize()
    longest = max(kw["steps"] for _fn, _ops, kw in groups)

    def measure(form, label, launches, lib, chain):
        """``launches``: (packing, the outputs it must give), timed one
        after another."""
        for pk, expect in launches:
            got = rd._direct_launch(pk, lib)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, expect)):
                raise AssertionError(f"{form} {label}: outputs differ from the plan's")
        ms = cs._cuda_ms(lambda: [rd._direct_launch(pk, lib) for pk, _w in launches], args.reps)
        occ = lib.mic_direct_occupancy(max(pk.smem_bytes for pk, _w in launches))
        summary["design_points"].append({"form": form, "launch": label,
                                         "launches": len(launches), "ms": ms,
                                         "ns_per_step": ms * 1e6 / chain,
                                         "blocks_per_sm": occ})
        print(f"{form:10s} {label:28s} {len(launches)} launch(es): {ms:7.3f} ms, "
              f"{ms * 1e6 / chain:7.1f} ns per step of the longest chain ({chain}), "
              f"{occ} blocks an SM", flush=True)
        return ms

    alone = []
    for (fn, ops, kw), w in zip(groups, want):
        n = min(SMS, ops[0].shape[0])
        alone.append((f"alone {fn.__name__[12:]} {kw}", kw["steps"],
                      rd.DirectPacking([(fn, tuple(o[:n] for o in ops), kw)], per_block=1),
                      [w[:n]]))
    for form, defines in FORMS:
        lib = kernel_library(defines)
        measure(form, "one", [(packing, want)], lib, longest)
        for label, steps, pk, w in alone:
            measure(form, label.replace(" 'steps'", "").replace("'", ""), [(pk, w)], lib, steps)
    lib = kernel_library()
    buckets = [(rd.DirectPacking([g]), [w]) for g, w in zip(groups, want)]
    measure("contiguous", "buckets", buckets, lib, longest)
    measure("contiguous", "least_load", [(_least_load(rd, groups), want)], lib, longest)
    measure("contiguous", "one_a_block", [(rd.DirectPacking(groups, per_block=1), want)], lib,
            longest)

    # pdd's column sum as torch.cumsum after the launch, as the plan ran it.
    bare = [(fn, ops, {k: v for k, v in kw.items() if k != "pdd_ws"}) for fn, ops, kw in groups]
    bare_pk = rd.DirectPacking(bare)
    keys = plan._direct_keys

    def cumsum_run():
        outs = rd._direct_launch(bare_pk, lib)
        res = []
        for k, o in zip(keys, outs):
            b = plan.buckets[k]
            if not b.pdd_ws:
                res.append(o.reshape(b.n, -1))
                continue
            w_, sh = b.geom
            need = w_ * sh
            o = o.reshape(b.n, -1)
            if o.shape[1] < need:
                o = torch.nn.functional.pad(o, (0, need - o.shape[1]))
            img = (o[:, :need].to(torch.int32) & 0xFFFF).reshape(b.n, sh, w_)
            res.append(rd._as_i16(torch.cumsum(img, dim=1, dtype=torch.int32)).reshape(b.n, -1))
        return res

    got = cumsum_run()
    fused = plan.run()
    torch.cuda.synchronize()
    if not all(torch.equal(g, fused[k]) for g, k in zip(got, keys)):
        raise AssertionError("pdd through torch.cumsum differs from the fused pixels")
    ms = cs._cuda_ms(cumsum_run, args.reps)
    summary["design_points"].append({"form": "contiguous", "launch": "pdd_cumsum", "ms": ms})
    print(f"contiguous pdd_cumsum: {ms:7.3f} ms (one launch without pdd's column sum, then "
          f"torch.cumsum on the pdd buckets)")
    run_ms = cs._cuda_ms(plan.run, args.reps)
    summary["plan_run_ms"] = run_ms
    print(f"plan.run(): {run_ms:.3f} ms (the direct launch; pdd's rows are views)")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
