"""mic-compress CLI (reference cmd/mic-compress/main.go; counterpart of
``mic_tpu.cli``).

Usage examples::

    python -m mic_tpu_torch.cli -input image.bin -width 512 -height 512 -output image.mic
    python -m mic_tpu_torch.cli -dicom study.dcm -output study.mic [-temporal]
    python -m mic_tpu_torch.cli -input image.bin -width 512 -height 512 -pics 8 -states 8 -output image.pics
    python -m mic_tpu_torch.cli -input image.bin -width 512 -height 512 -wavelet -output image.wav
    python -m mic_tpu_torch.cli -rgb slide.rgb -width 4096 -height 4096 -wsi -output slide.mic3
    python -m mic_tpu_torch.cli -decode image.mic -output raw.bin
    python -m mic_tpu_torch.cli -testdata -corpus DIR -outdir testdata_out
    python -m mic_tpu_torch.cli -input image.bin -width 512 -height 512 -micw -entropy best -output image.micw
    python -m mic_tpu_torch.cli -rgb tile.rgb -width 512 -height 384 -micw -output tile.mwr3
    python -m mic_tpu_torch.cli -decode tile.mwr3 -output tile.rgb -device cpu

For every argument list ``python -m mic_tpu.cli`` takes, the port writes
the same files, bytes and standard output.  Host formats, written and
read with numpy: MIC1 (single frame, ``-states``, ``-grad``), MIC2
(``-dicom`` with several frames, ``-temporal``), MICR (``-rgb``), MIC3
(``-rgb -wsi``), PICS (``-pics N``), PICA (``-pica N``), and the
wavelet V2 (``-wavelet``) and gap-removal (``-gap``) payloads.  Device
formats: MICW (``-input ... -micw``) and MWR3 (``-rgb ... -micw``),
encoded and decoded through the port's CUDA kernels.  Without
``-device``, ``-micw`` writes ``mic_tpu.cli``'s host bytes (``-entropy``,
``-predictor``), encoded on the card; with ``-device`` it writes
``mic_tpu.cli -device``'s (predictor zzd, entropy standard; the two flags
are ignored there, as ``mic_tpu.cli`` ignores them).  The codec stages of
the device formats (and a MIC2 frame stored as MICW) run on the GPU
unless ``-device cpu`` names the CPU (the kernels' plain PyTorch
versions).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

# The reference corpus -testdata reads from -corpus (cmd/mic-compress/main.go:409-811).
_CORPUS_IMAGES = (("MR", "MR_256_256_image.bin", 256, 256),
                  ("CT", "CT_512_512_image.bin", 512, 512))
_CORPUS_RGB = "wsi_tissue_512x384.rgb"
# Where the device formats' codec stages run when -device is absent.
DEFAULT_DEVICE = "cuda"


def _compress_fn(states: int):
    from .models import single_frame as sf

    return {
        1: sf.compress_single_frame,  # 2->1 chain is the reference default
        2: sf.compress_single_frame,
        4: sf.compress_single_frame_4state,
        8: sf.compress_single_frame_8state,
    }[states]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mic-compress", description=__doc__)
    ap.add_argument("-input", help="raw little-endian uint16 image")
    ap.add_argument("-dicom", help="DICOM file (single or multi-frame)")
    ap.add_argument("-rgb", help="raw interleaved RGB bytes (needs -width/-height)")
    ap.add_argument("-decode", help="decode a .mic/.pics/.pica/.mic2/.mic3/MICR/.micw/.mwr3 file")
    ap.add_argument("-width", type=int, default=0)
    ap.add_argument("-height", type=int, default=0)
    ap.add_argument("-output", help="output path")
    ap.add_argument("-states", type=int, default=2, choices=[1, 2, 4, 8])
    ap.add_argument("-temporal", action="store_true", help="MIC2 temporal mode")
    ap.add_argument("-pics", type=int, default=0, help="PICS strip count")
    ap.add_argument("-pica", type=int, default=0, help="PICA adaptive strip count")
    ap.add_argument("-micw", action="store_true", help="device strip format")
    ap.add_argument("-entropy", default="standard",
                    choices=["standard", "alias", "best"],
                    help="MICW strip entropy: standard FF 57, alias-mapped "
                         "FF 41 (tableLog-independent device decode), or "
                         "best (smaller of the two per strip)")
    ap.add_argument("-predictor", default="auto-fast",
                    choices=["auto-fast", "auto-r", "auto", "zzd", "vdd",
                             "pdd", "zzr", "vdr", "pdr", "zz", "avg"],
                    help="MICW strip predictor trial set: auto-fast "
                         "(speed-first direct modes), auto-r (+RLE'd direct "
                         "modes, ratio-first), auto (+classic escaped "
                         "modes), or one fixed mode")
    ap.add_argument("-wsi", action="store_true", help="MIC3 WSI (RGB input)")
    ap.add_argument("-wavelet", action="store_true", help="Wavelet V2 pipeline")
    ap.add_argument("-gap", action="store_true", help="gap-removal pipeline")
    ap.add_argument("-grad", action="store_true", help="gradient predictor")
    ap.add_argument("-testdata", action="store_true", help="compress the test corpus")
    ap.add_argument("-corpus", help="directory of the test corpus -testdata reads")
    ap.add_argument("-outdir", default="testdata_out")
    ap.add_argument("-device", nargs="?", const="cuda", default=None,
                    help="where the MICW/MWR3 codec stages run: cuda (CUDA kernels; "
                         "also when absent) or cpu (their plain PyTorch versions); "
                         "given, -micw writes mic_tpu.cli -device's bytes (zzd, "
                         "standard), absent, mic_tpu.cli's (-entropy, -predictor)")
    args = ap.parse_args(argv)
    device = torch.device(args.device or DEFAULT_DEVICE)

    from .utils.io import write_mic1, write_micr

    if args.testdata:
        if not args.corpus:
            print("testdata: pass -corpus DIR, the directory holding "
                  f"{', '.join(f for _n, f, _h, _w in _CORPUS_IMAGES)} and {_CORPUS_RGB}",
                  file=sys.stderr)
            return 2
        return _testdata(args.outdir, args.states, Path(args.corpus))

    if args.decode:
        return _decode(args, device)

    if args.dicom:
        from .parallel.multiframe import compress_multi_frame
        from .utils.dicom import read_dicom

        img = read_dicom(args.dicom)
        out_path = args.output or (args.dicom + ".mic")
        if len(img.frames) > 1:
            blob = compress_multi_frame(
                img.frames, img.cols, img.rows, img.max_value, args.temporal
            )
            Path(out_path).write_bytes(blob)
            print(f"MIC2 {img.cols}x{img.rows}x{len(img.frames)} -> {len(blob)} bytes")
        else:
            payload = _compress_fn(args.states)(img.pixels, img.cols, img.rows, img.max_value)
            Path(out_path).write_bytes(write_mic1(img.cols, img.rows, payload))
            print(f"MIC1 {img.cols}x{img.rows} -> {len(payload)} bytes")
        return 0

    if args.rgb:
        data = np.fromfile(args.rgb, dtype=np.uint8)
        w, h = args.width, args.height
        if w * h * 3 != len(data):
            print("rgb: need -width/-height matching the data", file=sys.stderr)
            return 2
        suffix = ".mic3" if args.wsi else (".mwr3" if args.micw else ".micr")
        out_path = args.output or (args.rgb + suffix)
        if args.wsi:
            from .parallel.wsi import WSIOptions, compress_wsi

            blob = compress_wsi(data, w, h, 3, 8, WSIOptions())
        elif args.micw:
            from .tpu.rgb_device import micwr_compress

            blob = micwr_compress(data, w, h, device)
        else:
            from .models.rgb import compress_rgb

            blob = write_micr(w, h, compress_rgb(data, w, h))
        kind = "MIC3" if args.wsi else ("MWR3" if args.micw else "MICR")
        Path(out_path).write_bytes(blob)
        print(f"{kind} {w}x{h} -> {len(blob)} bytes")
        return 0

    if not args.input:
        ap.print_help()
        return 2
    w, h = args.width, args.height
    px = np.fromfile(args.input, dtype="<u2", count=w * h) if w > 0 and h > 0 else None
    if px is None or len(px) != w * h:
        print("input: need -width/-height matching the data", file=sys.stderr)
        return 2
    mx = int(px.max())
    out_path = args.output or (args.input + ".mic")

    if args.pics:
        from .parallel.strips import (
            compress_parallel_strips,
            compress_parallel_strips_4state,
            compress_parallel_strips_8state,
        )

        fn = {2: compress_parallel_strips, 4: compress_parallel_strips_4state,
              8: compress_parallel_strips_8state}.get(args.states, compress_parallel_strips)
        blob = fn(px, w, h, mx, args.pics)
    elif args.pica:
        from .parallel.strips_adaptive import compress_parallel_strips_adaptive

        blob = compress_parallel_strips_adaptive(px, w, h, mx, args.pica)
    elif args.micw:
        from .tpu.rans_encode import micw_compress_device

        if args.device is None:
            blob = micw_compress_device(px, w, h, mx, device, entropy=args.entropy,
                                        predictor=args.predictor)
        else:
            blob = micw_compress_device(px, w, h, mx, device)
    elif args.wavelet:
        from .models.wavelet_pipeline import wavelet_v2_rle_fse_compress

        blob = wavelet_v2_rle_fse_compress(px, h, w, mx, 5)
    elif args.gap:
        from .ops.gapremoval import compress_single_frame_gap_removal

        blob = compress_single_frame_gap_removal(px, w, h, mx)
    elif args.grad:
        from .models.single_frame import compress_single_frame_grad

        blob = write_mic1(w, h, compress_single_frame_grad(px, w, h, mx))
    else:
        blob = write_mic1(w, h, _compress_fn(args.states)(px, w, h, mx))
    Path(out_path).write_bytes(blob)
    print(f"{w}x{h} {px.nbytes} -> {len(blob)} bytes (ratio {px.nbytes/len(blob):.3f})")
    return 0


def _decode(args, device) -> int:
    data = Path(args.decode).read_bytes()
    magic = data[:4]
    out_path = args.output or (args.decode + ".raw")
    if magic == b"MIC1":
        from .models.single_frame import decompress_single_frame
        from .utils.io import read_mic1

        w, h, _p, payload = read_mic1(data)
        px = decompress_single_frame(payload, w, h)
    elif magic == b"MIC2":
        from .parallel.multiframe import decompress_multi_frame

        frames, hdr = decompress_multi_frame(data, device)
        px = np.concatenate(frames)
        w, h = hdr.width, hdr.height
    elif magic == b"PICS":
        from .parallel.strips import decompress_parallel_strips

        px, w, h = decompress_parallel_strips(data)
    elif magic == b"PICA":
        from .parallel.strips_adaptive import decompress_parallel_strips_adaptive

        px, w, h = decompress_parallel_strips_adaptive(data)
    elif magic == b"MICW":
        from .tpu.strips import micw_decompress_device

        px, w, h = micw_decompress_device(data, device)
    elif magic == b"MWR3":
        from .tpu.rgb_device import micwr_decode_many

        rgb, w, h = micwr_decode_many([bytes(data)], device)[0]
        Path(out_path).write_bytes(bytes(np.asarray(rgb, np.uint8)))
        print(f"MWR3 {w}x{h} -> {np.asarray(rgb).size} bytes RGB")
        return 0
    elif magic == b"MICR":
        from .models.rgb import decompress_rgb
        from .utils.io import read_micr

        w, h, payload = read_micr(data)
        rgb = decompress_rgb(payload, w, h)
        Path(out_path).write_bytes(bytes(rgb))
        print(f"MICR {w}x{h} -> {len(rgb)} bytes RGB")
        return 0
    elif magic == b"MIC3":
        from .parallel.wsi import decompress_wsi_region, read_wsi_header

        hdr = read_wsi_header(data)
        out = decompress_wsi_region(data, 0, 0, 0, hdr.width, hdr.height)
        Path(out_path).write_bytes(out)
        print(f"MIC3 {hdr.width}x{hdr.height} -> {len(out)} bytes")
        return 0
    else:
        # Bare single-frame payloads need -width/-height.
        if args.width and args.height:
            from .models.single_frame import decompress_single_frame

            px = decompress_single_frame(data, args.width, args.height)
            w, h = args.width, args.height
        else:
            print(f"unknown magic {magic!r}; for bare payloads pass -width/-height",
                  file=sys.stderr)
            return 2
    np.asarray(px, dtype="<u2").tofile(out_path)
    print(f"decoded {w}x{h} -> {out_path}")
    return 0


def _testdata(outdir: str, states: int, corpus: Path) -> int:
    """Compress the reference corpus in ``corpus`` into every container (the
    analog of `mic-compress -testdata`, cmd/mic-compress/main.go:409-811);
    files missing from it are skipped."""
    from .models.rgb import compress_rgb
    from .parallel.strips import compress_parallel_strips_4state
    from .parallel.wsi import WSIOptions, compress_wsi
    from .utils.io import write_mic1, write_micr

    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    for name, fn, h, w in _CORPUS_IMAGES:
        p = corpus / fn
        if not p.exists():
            continue
        px = np.fromfile(p, dtype="<u2", count=w * h)
        mx = int(px.max())
        payload = _compress_fn(states)(px, w, h, mx)
        (out / f"{name}.mic").write_bytes(write_mic1(w, h, payload))
        (out / f"{name}_pics4.pics").write_bytes(
            compress_parallel_strips_4state(px, w, h, mx, 4)
        )
        print(f"{name}: mic + pics written")
    tis = corpus / _CORPUS_RGB
    if tis.exists():
        data = np.fromfile(tis, dtype=np.uint8)
        (out / "tissue.micr").write_bytes(write_micr(512, 384, compress_rgb(data, 512, 384)))
        (out / "tissue.mic3").write_bytes(compress_wsi(data, 512, 384, 3, 8, WSIOptions()))
        print("tissue: micr + mic3 written")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
