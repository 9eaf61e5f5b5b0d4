"""mic-compress CLI, the device paths (counterpart of ``mic_tpu.cli`` with
``-device``).

Usage examples::

    python -m mic_tpu_torch.cli -input image.bin -width 512 -height 512 -micw -output image.micw
    python -m mic_tpu_torch.cli -rgb tile.rgb -width 512 -height 384 -micw -output tile.mwr3
    python -m mic_tpu_torch.cli -decode image.micw -output raw.bin
    python -m mic_tpu_torch.cli -decode tile.mwr3 -output tile.rgb -device cpu

Formats: MICW (16-bit images, ``-input ... -micw``) and MWR3 (RGB,
``-rgb ... -micw``), encoded and decoded through the port's CUDA kernels,
with the bytes and pixels of ``python -m mic_tpu.cli ... -device``.  The
codec stages run on the GPU unless ``-device cpu`` names the CPU (the
kernels' plain PyTorch versions).  The host formats stay with
``mic_tpu.cli``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mic-compress", description=__doc__)
    ap.add_argument("-input", help="raw little-endian uint16 image")
    ap.add_argument("-rgb", help="raw interleaved RGB bytes (needs -width/-height)")
    ap.add_argument("-decode", help="decode a .micw or .mwr3 file")
    ap.add_argument("-width", type=int, default=0)
    ap.add_argument("-height", type=int, default=0)
    ap.add_argument("-output", help="output path")
    ap.add_argument("-micw", action="store_true", help="device strip format")
    ap.add_argument("-device", nargs="?", const="cuda", default="cuda",
                    help="where the MICW/MWR3 codec stages run: cuda (the default; "
                         "CUDA kernels) or cpu (their plain PyTorch versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    if args.decode:
        return _decode(args, device)

    if args.rgb:
        data = np.fromfile(args.rgb, dtype=np.uint8)
        w, h = args.width, args.height
        if w * h * 3 != len(data):
            print("rgb: need -width/-height matching the data", file=sys.stderr)
            return 2
        if not args.micw:
            print("rgb: the port writes MWR3 only (pass -micw)", file=sys.stderr)
            return 2
        from .tpu.rgb_device import micwr_compress

        blob = micwr_compress(data, w, h, device)
        Path(args.output or (args.rgb + ".mwr3")).write_bytes(blob)
        print(f"MWR3 {w}x{h} -> {len(blob)} bytes")
        return 0

    if not args.input or not args.micw:
        ap.print_help()
        return 2
    w, h = args.width, args.height
    px = np.fromfile(args.input, dtype="<u2", count=w * h)
    if len(px) != w * h:
        print("input: need -width/-height matching the data", file=sys.stderr)
        return 2
    from .tpu.rans_encode import micw_compress_device

    blob = micw_compress_device(px, w, h, int(px.max()), device)
    Path(args.output or (args.input + ".mic")).write_bytes(blob)
    print(f"{w}x{h} {px.nbytes} -> {len(blob)} bytes (ratio {px.nbytes/len(blob):.3f})")
    return 0


def _decode(args, device) -> int:
    data = Path(args.decode).read_bytes()
    magic = data[:4]
    out_path = args.output or (args.decode + ".raw")
    if magic == b"MICW":
        from .tpu.strips import micw_decompress_device

        px, w, h = micw_decompress_device(data, device)
    elif magic == b"MWR3":
        from .tpu.rgb_device import micwr_decode_many

        rgb, w, h = micwr_decode_many([bytes(data)], device)[0]
        Path(out_path).write_bytes(bytes(np.asarray(rgb, np.uint8)))
        print(f"MWR3 {w}x{h} -> {np.asarray(rgb).size} bytes RGB")
        return 0
    else:
        print(f"unknown magic {magic!r}: the port decodes MICW and MWR3; "
              "mic_tpu.cli decodes the host formats", file=sys.stderr)
        return 2
    np.asarray(px, dtype="<u2").tofile(out_path)
    print(f"decoded {w}x{h} -> {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
