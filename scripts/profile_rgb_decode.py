#!/usr/bin/env python3
"""Device-time breakdown of the port's W3D1 level-0 decode, in a process of
its own.

    python3 scripts/profile_rgb_decode.py [--reps N]

Builds ``chip_smoke.py``'s slide (a 4608x3584 RGB mosaic of
``web/testdata/tissue_dev.raw``), ingests it with
``w3d_compress(device_encode=True)`` on the card, stages level 0's 192
MWR3 tiles once and profiles the device part of ``micwr_decode_many``
(entropy launches, ``MicwDecodePlan.assemble_device``, crop, YCoCg-R
inverse, interleave) with torch.profiler, ``--reps`` times (default 3).
Prints, per repetition, the number of device records, the device-busy
milliseconds split into entropy kernels, the YCoCg-R kernel and the torch
ops around them, the span and the idle share, then the kernels by time;
and the CUDA-event milliseconds per decode for comparison.

``chip_smoke.py`` prints the same split from inside its long run, with
the same ``_profiled`` (which holds each window to one trace record a
counted launch); this script repeats it alone.  Needs an NVIDIA GPU and
nvcc.
Imports neither jax nor anything of mic_tpu.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    import chip_smoke as cs
    from mic_tpu_torch import w3d_compress, w3d_header
    from mic_tpu_torch.tpu import rgb_device, wsi_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_rgb_decode: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    slide, width, height = cs._slide()
    blob = w3d_compress(slide.reshape(-1), width, height, dev, tile_w=cs.TILE, tile_h=cs.TILE,
                        device_encode=True)
    _hdr, entries, off = w3d_header(blob)
    tiles = [blob[off + e[4] : off + e[4] + e[5]] for e in entries
             if e[0] == 0 and e[3] == wsi_device.TILE_MWR3]
    metas, plan = rgb_device._stage(tiles, dev)

    def run():
        return rgb_device._run(metas, plan)

    ms = cs._cuda_ms(run, 10)
    n_bytes = 3 * cs.TILE * cs.TILE * len(tiles)
    print(f"level-0 decode: {len(tiles)} tiles, {len(plan.buckets)} entropy launches, "
          f"{ms:.3f} ms per decode (CUDA events), {n_bytes / (ms / 1e3) / 1e9:.3f} GB/s "
          f"of RGB bytes out")
    for rep in range(args.reps):
        records = []
        _out, wall_ms, by_name, span = cs._profiled(run, records)
        busy = sum(by_name.values())
        ent = sum(v for k, v in by_name.items() if "rans_" in k)
        ycc = sum(v for k, v in by_name.items() if "ycocgr" in k)
        print(f"profile {rep}: records={len(records)} wall_ms={wall_ms:.3f} "
              f"device_busy_ms={busy:.3f} device_span_ms={span:.3f} "
              f"idle_share_of_span={1 - busy / span if span else float('nan'):.3f} "
              f"entropy_kernels_ms={ent:.3f} ycocgr_kernel_ms={ycc:.3f} "
              f"assemble_and_other_torch_ops_ms={busy - ent - ycc:.3f}")
    for name, kms in sorted(by_name.items(), key=lambda kv: -kv[1]):
        print(f"profile: {kms:8.3f} ms {100 * kms / busy:5.1f}%  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
