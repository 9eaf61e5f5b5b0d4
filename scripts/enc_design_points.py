#!/usr/bin/env python3
"""Times the rANS encode kernel's design points on the card, one by one.

    python3 scripts/enc_design_points.py [--reps N]

Stages ``chip_smoke.py``'s phase 2 encode operands (CT_dev x128: 1536
candidate streams of 512 steps, FF 57 and FF 41) and times
``csrc/rans_encode.cu`` in its forms, each built with the source's
``MIC_ENC_*`` macros into a library of its own:

* ``map_runs`` (the default): FF 41's slot read from a map of the strip's
  slots built in the block's prologue a run at a time (a thread a run);
  the rank of step t - 2 and the table entries of step t - 1 loaded during
  step t; two steps an iteration; 128 threads a strip;
* ``map_slots``: the map filled a slot at a time, one search each
  (``MIC_ENC_SLOT=2``);
* ``search``: the 9-round search on every step (``MIC_ENC_SLOT=0``);
* ``eytzinger``: the run starts in breadth-first order, searched
  (``MIC_ENC_SLOT=3``);
* ``prefetch1`` / ``prefetch0``: the rank one step ahead / nothing ahead
  (``MIC_ENC_PREFETCH=1`` / ``0``);
* ``warp``: a warp a strip, four lanes a thread (``MIC_ENC_TEAM=32``);
* ``unroll1``: one step an iteration (``MIC_ENC_UNROLL=1``);
* ``as_before``: the search, nothing ahead, one step an iteration: the
  kernel before the map (``MIC_ENC_SLOT=0 MIC_ENC_PREFETCH=0
  MIC_ENC_UNROLL=1``).

Each form runs with the per-stream table widths (``own``, the main path's
call) and at the batch width (``batch``: every strip stages aw entries),
and on the first 8 steps alone (``short``: the launch's fixed cost, the
prologue with its map build included, plus 8 steps).  The forms are timed
in two rounds, the second in reverse order.  Every output at full length
must equal the plain twin's.  Prints each point's ms, ns a step of the
launch, shared memory a block, blocks an SM and waves, and each form's
registers and spills, then a JSON summary.  Milliseconds from CUDA events
around ``--reps`` launches queued behind a spinning kernel
(``torch.cuda._sleep``), so the host's time to launch is not counted,
after a warm-up.  Needs an NVIDIA GPU and nvcc.
Imports neither jax nor anything of mic_tpu.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FORMS = [("map_runs", ()), ("map_slots", ("-DMIC_ENC_SLOT=2",)),
         ("search", ("-DMIC_ENC_SLOT=0",)), ("eytzinger", ("-DMIC_ENC_SLOT=3",)),
         ("prefetch1", ("-DMIC_ENC_PREFETCH=1",)), ("prefetch0", ("-DMIC_ENC_PREFETCH=0",)),
         ("warp", ("-DMIC_ENC_TEAM=32",)), ("unroll1", ("-DMIC_ENC_UNROLL=1",)),
         ("as_before", ("-DMIC_ENC_SLOT=0", "-DMIC_ENC_PREFETCH=0", "-DMIC_ENC_UNROLL=1"))]
SHORT = 8  # steps of the short launch


def _registers(log: str) -> str:
    """Registers and spills of the two encode kernels, from nvcc's
    ``-Xptxas=-v`` report."""
    out, form = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            form = ("FF 41" if "rans_enc_kernelILb1" in line else "FF 57"
                    if "rans_enc_kernel" in line else None)
        elif form and "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif form and "Used" in line and "registers" in line:
            out.append(f"{form} {line.split('Used ')[1].split(',')[0]}, {spill}")
            form = None
    return "; ".join(out)


def _gpu_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()``: the launches are queued while
    the card spins, so the events time the launches back to back."""
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("enc_design_points: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from mic_tpu_torch._build import build, kernel_library
    from mic_tpu_torch.tpu import rans_encode as renc

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = {}
    for name, defines in FORMS:
        log = build(defines).with_suffix(".log")
        libs[name] = kernel_library(defines)
        if log.exists():  # absent when an earlier run built the library
            print(f"{name}: {_registers(log.read_text())}")
    summary = {}
    for alias, wrapper in ((False, renc.rans_encode), (True, renc.rans_encode_alias)):
        staged, ops, widths = cs._encode_operands(dev, alias)
        steps, (S, aw) = staged.steps, ops[1].shape
        rk, te1, te2 = ops[:3]
        ar1, ar2 = ops[3:5] if alias else (None, None)
        count, tls = ops[-2:]
        short = (rk[:, :SHORT].contiguous(), te1, te2, ar1, ar2,
                 count.clamp(max=SHORT * 128), tls)
        plain = (renc.rans_encode_alias_plain if alias else renc.rans_encode_plain)
        want = plain(*ops, steps=steps, widths=widths)
        torch.cuda.synchronize()
        form_name = wrapper.__name__
        for rnd, forms in enumerate((FORMS, FORMS[::-1])):
            for name, _d in forms:
                lib = libs[name]
                smem, per_sm, threads = renc._launch_shape(aw, alias, lib)
                for label, wd in (("own", widths), ("batch", None)):
                    def call(lib=lib, wd=wd):
                        return renc._encode_launch(wrapper, rk, te1, te2, ar1, ar2, count,
                                                   tls, steps, wd, lib=lib)

                    got = call()
                    torch.cuda.synchronize()
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(f"{form_name} {name} {label}: != the plain twin")
                    ms = _gpu_ms(call, args.reps)
                    summary.setdefault(f"{form_name} {name} {label}", []).append(ms)
                    print(f"[{rnd}] {form_name} {name:10s} {label:5s}: {ms:.4f} ms, "
                          f"{ms * 1e6 / steps:.1f} ns a step of the launch ({S} streams x "
                          f"{steps} steps, table width {aw}), {smem} bytes of shared memory a "
                          f"block of {threads} threads, {per_sm} blocks an SM, "
                          f"{S / (per_sm * sms):.2f} waves", flush=True)
                ms = _gpu_ms(lambda lib=lib: renc._encode_launch(
                    wrapper, *short, SHORT, widths, lib=lib), args.reps)
                summary.setdefault(f"{form_name} {name} short", []).append(ms)
                print(f"[{rnd}] {form_name} {name:10s} short: {ms:.4f} ms for {SHORT} steps "
                      f"(the launch's fixed cost with the prologue)", flush=True)
        del ops, want
    print(json.dumps({"ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
