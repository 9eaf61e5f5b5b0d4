"""MICW container parse, strip encode helpers and the batch decode plan.

Port of ``mic_tpu.tpu.strips``, in four parts:

* the container parse (a jax-free copy, pinned to the original by the
  tests);
* the encode side shared by the host and device encoders: the direct
  predictors' symbol transforms, candidate generation, the requests the
  device batch encoder pre-encodes and the size-first selection
  (``_strip_candidates`` / ``_strip_requests`` / ``_strip_select``,
  jax-free copies pinned byte for byte by the tests; the device encoder
  itself is ``rans_encode.micw_compress_device_many``);
* ``MicwDecodePlan`` / ``micw_decode_many`` / ``micw_decompress_device``
  for every strip mode (zzd, vdd, pdd, zzr, vdr, pdr, zz, avg) at any
  width and any lane count, on both entropy families (FF 57 standard at
  tableLog up to 16, FF 41 alias at any tableLog); ``micw_decompress_scan``
  / ``micw_decode_batch``, the scan tier alone;
* the host encoder ``micw_compress`` at any lane count and the host
  decoder ``micw_decompress_host`` (numpy, no device: the independent
  cross-check of the device decode), jax-free copies pinned byte for
  byte and pixel for pixel.

The plan pools the strips of every image of a batch into buckets; the
direct buckets and the post buckets' entropy stages run together as one
launch of the direct kernel (``rans_decode_direct_groups``), the r-mode
buckets as one launch of the r-kernel
(``rans_decode_rle_groups``), the scan buckets as one launch of the
lanes kernel (``scan_decode.rans_decode_lanes_groups``).  A strip takes
a fused kernel where ``mic_tpu``'s plan does: zzd, pdd and vdd
(width/128 in {1, 2, 4, 8}) and the r-modes (vdr likewise) at widths that
are a multiple of 128, FF 41 or FF 57 with packed tables (tableLog <= 12,
alphabet <= 4096).  Those buckets are keyed on (entropy family,
predictor, padded step count, geometry and, for the r-modes, the
container's FLAG_RDENSE).  Every other strip takes the post path: a
symbols-out entropy stage in the direct kernel's launch (packed tables,
two tables, or the alias front end with ``fused=False``) and then the
post stage, keyed on (entropy form, predictor, padded step count, width,
strip height and the post constants mid / delim), as ``mic_tpu`` keys
its post groups.  The second (column) prefix sum of pdd runs in the
direct kernel (``pdd_ws``), except on a row too wide for the kernel's
column carry, where it is a plain ``torch.cumsum`` as pdr's is on the
r-kernel's output, as ``mic_tpu`` leaves both to XLA.  Raw and constant strips are copied on the
host.

Strips with lanes != 128 and FF 41 strips with tableLog > 12 take the
scan tier, as in ``mic_tpu``: the L-lane lanes kernel, keyed on ("scan",
lanes, padded step count, predictor, width, strip height, mid, delim);
FF 57 and FF 41 strips and tableLogs mix in such a bucket (its FF 41
strips of up to ``scan_decode.WARP_LANES`` lanes also carry their
128-bucket alias tables, ``scan_decode.build_lane_operands``, which the
kernel reads in place of their slot tables; the staging counter
``strips.scan_alias_buckets`` counts them).  A zzd, vdd
or pdd bucket whose width is a multiple of its lanes, of up to
``scan_decode.WARP_LANES`` lanes, runs its inverse in the kernel
(``scan_decode.fused_strip_fits``); every other scan bucket takes the
kernel's symbols and then the post stage.  The post stage of every post
bucket of a plan (the SoA-RLE expand, the escape parse and the zz / avg /
direct inverses) is one launch of ``csrc/post.cu``
(``post.post_decode_groups``, ``post.PostPacking``), ``post.post_batch``
its plain twin, which only CPU tensors take.  A strip whose table entry
claims more runs than symbols, or more pixels (zz, avg: tokens) than its
strip can hold, raises ``ValueError``.

Container layout::

    "MICW" | width u32 | height u32 | numStrips u32 | stripH u32
    maxValue u16 | flags u8 | lanes_log2 u8
    [FLAG_BANDED: orig_width u32 | orig_height u32]
    per strip: offset u32 | length u32 | nSoa u32 | nTokens u32 | nRuns u32 | nSame u32 | mode u32
    concatenated MICT entropy blobs (one per strip)
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from .. import trace
from ..ops.fse import IncompressibleError, UseRLEError
from ..ops.predictors import (
    _interleave_escapes,
    delta_params,
    parse_escaped,
    predictor_decode,
    predictor_encode,
    zigzag,
)
from ..ops.rle import soa_encode, soa_expand
from .device_rans import ALIAS_MAX_KEPT, mict_decode_numpy, mict_encode, mict_parse
from .post import PostPacking, post_decode, post_decode_groups
from .rans_decode import (
    MID_DIRECT,
    DirectPacking,
    RlePacking,
    _as_i16,
    build_alias_bucket_tables,
    build_packed_tables,
    build_pallas_tables,
    direct_strip_fits,
    rans_decode,
    rans_decode_alias,
    rans_decode_direct_groups,
    rans_decode_packed,
    rans_decode_rle,
    rans_decode_rle_alias,
    rans_decode_rle_groups,
    rans_decode_zzd,
    to_device,
)
from .scan_decode import (
    LANES_MAX,
    LanesPacking,
    build_lane_operands,
    fused_strip_fits,
    lane_tensors,
    rans_decode_lanes,
    rans_decode_lanes_groups,
)
from .verify import MismatchPacking, bucket_mismatches_plain, count_mismatches, expected_rows

__all__ = [
    "micw_parse",
    "micw_band_info",
    "band_split",
    "band_merge",
    "strip_predictor",
    "micw_compress",
    "micw_decompress_host",
    "MicwDecodePlan",
    "micw_decode_many",
    "micw_decompress_device",
    "micw_decompress_scan",
    "micw_decode_batch",
    "MICW_MAGIC",
    "MICW_BAND_W",
]

MICW_MAGIC = b"MICW"
MICW_HEADER = 24
MICW_ENTRY = 28
FLAG_AVG_PREDICTOR = 0x01
FLAG_DIRECT = 0x02  # zz-direct: no RLE, no escapes (mod-2^16 ZigZag diffs)
FLAG_ADAPTIVE = 0x04  # v4: per-strip predictor modes
FLAG_BANDED = 0x08  # v5: wide images stored as stacked column bands
FLAG_RDENSE = 0x10  # v6: r-mode run streams are dense
STRIP_MODE_MICT = 0  # legacy: predictor from the global flags
STRIP_MODE_RAW = 1  # raw u16 pixels
STRIP_MODE_ZZD = 2  # zz-direct (no RLE)
STRIP_MODE_ZZ = 3  # zz + SoA-RLE + escapes
STRIP_MODE_AVG = 4  # avg + SoA-RLE + escapes
STRIP_MODE_CONST = 5  # constant strip: payload is ONE u16 value
STRIP_MODE_VDD = 6  # vertical-direct (up-delta, no RLE)
STRIP_MODE_PDD = 7  # plane-direct (W+N-NW delta, no RLE)
STRIP_MODE_ZZR = 8  # zz-direct + SoA-RLE
STRIP_MODE_VDR = 9  # vertical-direct + SoA-RLE
STRIP_MODE_PDR = 10  # plane-direct + SoA-RLE
RDENSE_MIN_SAME = 16  # r-mode same-runs span >= 16 px (FLAG_RDENSE)
MAX_TABLE_LOG = 11  # FF 57 encode cap (the decode reads tl <= 12)
MAX_ALPHABET = 4096  # packed-kernel cap (12-bit rank)
ALIAS_TABLE_LOG = 12  # alias-kernel cap (12-bit bucket-table fields)
MICW_BAND_W = 512  # column-band width for FLAG_BANDED containers

_MODE_PRED = {
    STRIP_MODE_ZZD: "zzd",
    STRIP_MODE_ZZ: "zz",
    STRIP_MODE_AVG: "avg",
    STRIP_MODE_VDD: "vdd",
    STRIP_MODE_PDD: "pdd",
    STRIP_MODE_ZZR: "zzr",
    STRIP_MODE_VDR: "vdr",
    STRIP_MODE_PDR: "pdr",
}
_DIRECT_PREDS = ("zzd", "vdd", "pdd")  # no RLE, no escapes
_RLE_DIRECT_PREDS = ("zzr", "vdr", "pdr")  # SoA-RLE, no escapes
_RLE_FNS = (rans_decode_rle, rans_decode_rle_alias)  # the r-kernel's one-bucket wrappers
# the direct kernel's one-bucket wrappers: the direct modes, and the post
# path's symbols-out forms
_DIRECT_FNS = (rans_decode_zzd, rans_decode_alias, rans_decode_packed, rans_decode)
AUTO_FAST_TRIALS = ("zzd", "vdd", "pdd")  # scan-parallel decode modes only
_PRED_MODE = {v: k for k, v in _MODE_PRED.items()}


def strip_predictor(global_pred: str, mode: int) -> str | None:
    """Effective predictor of one strip (None = raw or constant)."""
    if mode in (STRIP_MODE_RAW, STRIP_MODE_CONST):
        return None
    if mode == STRIP_MODE_MICT:
        return global_pred
    return _MODE_PRED[mode]


def _rle_mid(max_value: int) -> int:
    """MICW's RLE midCount: derived from the escape delimiter like the
    host formats, but floored at 127."""
    _thr, delim = delta_params(max_value)
    delim = max(int(delim), 255)
    return (1 << (delim.bit_length() - 1)) - 1


def _zigzag16(d: np.ndarray) -> np.ndarray:
    """mod-2^16 ZigZag of int64 differences, as u16 symbols."""
    d16 = d.astype(np.uint16).astype(np.int16)
    return (
        ((d16.astype(np.int32) << 1) ^ (d16.astype(np.int32) >> 15)) & 0xFFFF
    ).astype(np.uint16).ravel()


def _zzd_syms(strip_px: np.ndarray, width: int, sh: int) -> np.ndarray:
    """zz-direct symbols: per-row mod-2^16 ZigZag left-deltas."""
    img = strip_px.reshape(sh, width).astype(np.int64)
    left = np.zeros_like(img)
    left[:, 1:] = img[:, :-1]
    return _zigzag16(img - left)


def _vdd_syms(strip_px: np.ndarray, width: int, sh: int) -> np.ndarray:
    """Vertical-direct symbols: per-column mod-2^16 ZigZag up-deltas."""
    img = strip_px.reshape(sh, width).astype(np.int64)
    up = np.zeros_like(img)
    up[1:, :] = img[:-1, :]
    return _zigzag16(img - up)


def _pdd_syms(strip_px: np.ndarray, width: int, sh: int) -> np.ndarray:
    """Plane-direct symbols: mod-2^16 ZigZag of p - W - N + NW (zero
    boundary); the inverse is two prefix sums."""
    img = strip_px.reshape(sh, width).astype(np.int64)
    w = np.zeros_like(img)
    w[:, 1:] = img[:, :-1]
    n = np.zeros_like(img)
    n[1:, :] = img[:-1, :]
    nw = np.zeros_like(img)
    nw[1:, 1:] = img[:-1, :-1]
    return _zigzag16(img - w - n + nw)


_DIRECT_SYMS = {
    "zzd": _zzd_syms, "vdd": _vdd_syms, "pdd": _pdd_syms,
    "zzr": _zzd_syms, "vdr": _vdd_syms, "pdr": _pdd_syms,
}


def _escaped_tokens(strip_px, width, sh, max_value, pred) -> np.ndarray:
    """Escaped residual token stream including the leading maxValue word
    (the fused Delta+RLE layout of the zz and avg modes)."""
    thr, delim = delta_params(max_value)
    if pred == "zz":
        img = np.asarray(strip_px, dtype=np.uint16).reshape(sh, width)
        p = img.astype(np.int64)
        left = np.zeros_like(p)
        left[:, 1:] = p[:, :-1]
        diff = p - left
        escape = np.abs(diff) >= thr
        stream = _interleave_escapes(
            zigzag(diff.astype(np.int16)).ravel(), img.ravel(), escape.ravel(), delim
        )
    else:
        stream = predictor_encode(strip_px, width, sh, max_value, "avg")
    return np.concatenate(
        [np.array([max_value], dtype=np.uint16), stream.astype(np.uint16)]
    )


def _estimate_bytes(syms: np.ndarray, alias: bool = False,
                    counts: np.ndarray | None = None) -> float:
    """Zeroth-order entropy size estimate for ranking candidates; +inf
    for alphabets no kernel takes.  Alias alphabets beyond the 255 kept
    symbols are modelled as escape-folded (2 bytes per escape)."""
    if counts is None:
        counts = np.bincount(syms)
    nz = counts[counts > 0]
    n = len(syms)
    if alias and len(nz) > ALIAS_MAX_KEPT:
        kept = np.sort(nz)[::-1][:ALIAS_MAX_KEPT].astype(np.int64)
        esc = n - int(kept.sum())
        parts = np.concatenate([kept, [esc]]) if esc else kept
        p = parts / n
        h_bits = float(-(p * np.log2(p)).sum()) * n
        return h_bits / 8 + 1.2 * len(parts) + 2.0 * esc
    if len(nz) > (MAX_ALPHABET if not alias else 65536):
        return float("inf")
    p = nz / n
    h_bits = float(-(p * np.log2(p)).sum()) * n
    return h_bits / 8 + 1.2 * len(nz)  # ~ncount header cost per symbol


def _trials_for(predictor: str) -> list[str]:
    """Trial set of a predictor spec: "auto" (every mode), "auto-r"
    (direct + RLE'd direct), "auto-fast" (direct only) or one mode."""
    if predictor == "auto":
        return ["zzd", "vdd", "pdd", "zzr", "vdr", "pdr", "zz", "avg"]
    if predictor == "auto-r":
        return list(_DIRECT_PREDS) + list(_RLE_DIRECT_PREDS)
    if predictor == "auto-fast":
        return list(AUTO_FAST_TRIALS)
    if predictor in _MODE_PRED.values():
        return [predictor]
    raise ValueError(f"micw: unknown predictor {predictor!r}")


def _r_margin() -> float:
    """``MICW_R_MARGIN`` (the reference's variable, read the same way):
    minimum fractional size win a non-direct strip candidate must show
    over the best direct one (0 = pure size, the default)."""
    try:
        return float(os.environ.get("MICW_R_MARGIN", "0"))
    except ValueError:
        return 0.0


def _strip_candidates(strip_px, width, sh, max_value, mid, trials, entropy):
    """Phase 1 of strip encoding: the candidate streams
    [(est, syms, counts, meta, mode)], sorted by the H0 size estimate."""
    candidates = []
    direct_cache = {}

    def direct_syms(key):
        if key not in direct_cache:
            direct_cache[key] = _DIRECT_SYMS[key](strip_px, width, sh)
        return direct_cache[key]

    for pred in trials:
        if pred in _DIRECT_PREDS:
            syms = direct_syms(pred)
            meta = (len(syms), len(syms), 0, 0)
        elif pred in _RLE_DIRECT_PREDS:
            base = direct_syms({"zzr": "zzd", "vdr": "vdd",
                                "pdr": "pdd"}[pred])
            syms, n_runs, n_same = soa_encode(base, MID_DIRECT,
                                              min_same=RDENSE_MIN_SAME)
            meta = (len(syms), len(base), n_runs, n_same)
        else:
            tokens = _escaped_tokens(strip_px, width, sh, max_value, pred)
            syms, n_runs, n_same = soa_encode(tokens, mid)
            meta = (len(syms), len(tokens), n_runs, n_same)
        # "best" keeps wide-alphabet candidates standard would drop:
        # alias can escape-fold them.
        cnts = np.bincount(syms)
        est = _estimate_bytes(syms, alias=entropy in ("alias", "best"),
                              counts=cnts)
        if est != float("inf"):
            candidates.append((est, syms, cnts, meta, _PRED_MODE[pred]))
    candidates.sort(key=lambda c: c[0])
    return candidates


def _strip_requests(candidates, n_trials, entropy):
    """Every (candidate_idx, alias) pair :func:`_strip_select` may ask
    its encoder for: the device batch encoder pre-encodes exactly this
    set."""
    use_alias = entropy == "alias"
    direct_modes = {_PRED_MODE[p] for p in _DIRECT_PREDS}
    reqs = set()
    for i in range(min(5 if n_trials > 1 else 1, len(candidates))):
        reqs.add((i, use_alias))
        if entropy == "best":
            reqs.add((i, True))
    if _r_margin() > 0.0:
        for i, c in enumerate(candidates):
            if c[4] in direct_modes:
                reqs.add((i, use_alias))
                if entropy == "best":
                    reqs.add((i, True))
    return sorted(reqs)


def _strip_select(candidates, strip_px, n_trials, entropy, enc):
    """Phase 2 of strip encoding: pick the winning blob.  ``enc(i,
    alias)`` returns candidate i's encoded bytes or None.  Size-first
    over the top five estimates, with the "best" dual encode, the
    MICW_R_MARGIN guard and the raw fallback.  Returns (blob, (n_soa,
    n_tok, n_runs, n_same, mode))."""
    use_alias = entropy == "alias"
    best = best_direct = None  # (len, blob, meta, mode)
    direct_modes = {_PRED_MODE[p] for p in _DIRECT_PREDS}

    def enc_best(i):
        blob = enc(i, use_alias)
        if entropy == "best":
            blob_a = enc(i, True)
            if blob_a is not None and (blob is None or len(blob_a) < len(blob)):
                blob = blob_a
        return blob

    for i, (_est, _syms, _cnts, meta, mode) in enumerate(
            candidates[: 5 if n_trials > 1 else 1]):
        blob = enc_best(i)
        if blob is None:
            continue
        if best is None or len(blob) < best[0]:
            best = (len(blob), blob, meta, mode)
        if mode in direct_modes and (best_direct is None
                                     or len(blob) < best_direct[0]):
            best_direct = (len(blob), blob, meta, mode)
    margin = _r_margin()
    if (best is not None and best_direct is None and margin > 0.0
            and best[3] not in direct_modes):
        # The margin needs a direct comparator: encode the best-estimated
        # direct candidate explicitly.
        for i, (_est, _syms, _cnts, meta, mode) in enumerate(candidates):
            if mode not in direct_modes:
                continue
            blob = enc_best(i)
            if blob is not None:
                best_direct = (len(blob), blob, meta, mode)
                break
    if (best is not None and best_direct is not None
            and best[3] not in direct_modes and margin > 0.0
            and best[0] > (1.0 - margin) * best_direct[0]):
        best = best_direct
    raw = strip_px.astype("<u2").tobytes()
    if best is None or best[0] >= len(raw):
        n = len(strip_px)
        return raw, (n, n, 0, 0, STRIP_MODE_RAW)
    return best[1], (*best[2], best[3])


def _encode_candidate(syms: np.ndarray, lanes: int, max_bytes: int | None = None,
                      alias: bool = False, counts: np.ndarray | None = None):
    """The host encode of one candidate stream at ``lanes`` lanes, FF 57 at
    tableLog <= 11 or FF 41 at <= 12; None where the strip falls through
    to other candidates or raw."""
    try:
        return mict_encode(syms, lanes=lanes,
                           max_table_log=ALIAS_TABLE_LOG if alias else MAX_TABLE_LOG,
                           max_bytes=max_bytes, alias=alias, counts=counts)
    except (IncompressibleError, UseRLEError, ValueError):
        return None


def _strip_layout(pixels, width: int, height: int, num_strips: int):
    """The strip geometry of a MICW encode: (pixels, width, height,
    strips, strip_h, band) in the stacked band space, ``band`` the
    (orig_width, orig_height) of a FLAG_BANDED image, else None.  Images
    wider than MICW_BAND_W whose width divides into bands are banded;
    ``num_strips`` <= 0 picks 128-row strips, scaled by the band count."""
    pixels = np.asarray(pixels, dtype=np.uint16)
    if len(pixels) != width * height:
        raise ValueError("micw: pixel count mismatch")
    orig_w, orig_h = width, height
    band = None
    if width > MICW_BAND_W and width % MICW_BAND_W == 0:
        pixels, width, height = band_split(pixels, width, height)
        band = (orig_w, orig_h)
    if num_strips <= 0:
        rows = 128 * (orig_w // width if band else 1)
        num_strips = max(1, height // rows)
    num_strips = max(1, min(num_strips, height))
    strip_h = (height + num_strips - 1) // num_strips
    return pixels, width, height, (height + strip_h - 1) // strip_h, strip_h, band


def _micw_container(width, height, strip_h, max_value, predictor, band, blobs, metas,
                    lanes: int = 128) -> bytes:
    """A MICW container from its strips' blobs and table entries (n_soa,
    n_tok, n_runs, n_same, mode), as ``micw_compress`` writes it."""
    out = bytearray()
    out += MICW_MAGIC
    out += struct.pack("<IIII", width, height, len(blobs), strip_h)
    flags = FLAG_ADAPTIVE | {"avg": FLAG_AVG_PREDICTOR, "zzd": FLAG_DIRECT}.get(predictor, 0)
    if band is not None:
        flags |= FLAG_BANDED
    r_modes = {_PRED_MODE[p] for p in _RLE_DIRECT_PREDS}
    if any(m[4] in r_modes for m in metas):
        flags |= FLAG_RDENSE
    out += struct.pack("<HBB", max_value, flags, int(np.log2(lanes)))
    if band is not None:
        out += struct.pack("<II", *band)
    offset = 0
    for blob, (n_soa, n_tok, n_runs, n_same, mode) in zip(blobs, metas):
        out += struct.pack("<IIIIIII", offset, len(blob), n_soa, n_tok, n_runs, n_same, mode)
        offset += len(blob)
    return bytes(out) + b"".join(blobs)


def micw_compress(pixels, width: int, height: int, max_value: int, num_strips: int = 0,
                  lanes: int = 128, predictor: str = "auto-fast",
                  entropy: str = "standard") -> bytes:
    """The host MICW encoder at any lane count, byte-identical to
    ``mic_tpu.tpu.strips.micw_compress``: per strip the candidates of the
    ``predictor`` trial set ("auto-fast", "auto-r", "auto" or one mode),
    size-first selection over the top five encodes, constant and raw
    strips.  ``entropy`` is "standard" (FF 57), "alias" (FF 41) or
    "best" (each winning candidate both ways, the smaller kept).  The
    device encoder (``rans_encode.micw_compress_device_many``) writes the
    same bytes at 128 lanes."""
    if entropy not in ("standard", "alias", "best"):
        raise ValueError(f"micw: unknown entropy {entropy!r}")
    pixels, width, height, actual, strip_h, band = _strip_layout(pixels, width, height,
                                                                 num_strips)
    mid = _rle_mid(max_value)
    trials = _trials_for(predictor)

    def encode_strip(s):
        y0 = s * strip_h
        y1 = min(y0 + strip_h, height)
        strip_px = pixels[y0 * width : y1 * width]
        if strip_px[0] == strip_px.max() and strip_px[0] == strip_px.min():
            return strip_px[:1].astype("<u2").tobytes(), (0, 0, 0, 0, STRIP_MODE_CONST)
        candidates = _strip_candidates(strip_px, width, y1 - y0, max_value, mid,
                                       trials, entropy)

        def enc(i, alias):
            return _encode_candidate(candidates[i][1], lanes, max_bytes=strip_px.nbytes,
                                     alias=alias, counts=candidates[i][2])

        return _strip_select(candidates, strip_px, len(trials), entropy, enc)

    with trace.span("encode"):
        results = [encode_strip(s) for s in range(actual)]
    return _micw_container(width, height, strip_h, max_value, predictor, band,
                           [r[0] for r in results], [r[1] for r in results], lanes)


def band_split(pixels: np.ndarray, width: int, height: int,
               band_w: int = MICW_BAND_W):
    """Split a wide image into vertically-stacked column bands: a
    (h, B*bw) image becomes a (B*h, bw) image, band b in rows
    [b*h, (b+1)*h).  Returns (stacked pixels, band_w, B*h)."""
    bands = width // band_w
    img = np.asarray(pixels, dtype=np.uint16).reshape(height, width)
    stacked = img.reshape(height, bands, band_w).transpose(1, 0, 2)
    return np.ascontiguousarray(stacked).reshape(-1), band_w, bands * height


def band_merge(stacked: np.ndarray, band_w: int, orig_w: int, orig_h: int) -> np.ndarray:
    """Inverse of :func:`band_split`."""
    bands = orig_w // band_w
    img = np.asarray(stacked, dtype=np.uint16).reshape(bands, orig_h, band_w)
    return np.ascontiguousarray(img.transpose(1, 0, 2)).reshape(-1)


def micw_band_info(blob: bytes):
    """(orig_width, orig_height) of a FLAG_BANDED container, else None.
    Decoding runs in the stacked band space that micw_parse reports;
    only the user-facing results are un-banded."""
    if len(blob) < MICW_HEADER or blob[:4] != MICW_MAGIC:
        raise ValueError("micw: invalid magic")
    flags = blob[22]
    if not flags & FLAG_BANDED:
        return None
    if len(blob) < MICW_HEADER + 8:
        raise ValueError("micw: truncated banded extension")
    return struct.unpack_from("<II", blob, MICW_HEADER)


def _unband(pixels: np.ndarray, width: int, height: int, blob: bytes):
    info = micw_band_info(blob)
    if info is None:
        return pixels, width, height
    ow, oh = info
    return band_merge(pixels, width, ow, oh), ow, oh


def micw_parse(blob: bytes):
    """Returns (width, height, num_strips, strip_h, max_value, predictor,
    lanes, strips) with strips = [(mict bytes, n_soa, n_tok, n_runs,
    n_same, mode)]; width/height are the stacked band space's."""
    if len(blob) < MICW_HEADER or blob[:4] != MICW_MAGIC:
        raise ValueError("micw: invalid magic")
    width, height, num_strips, strip_h = struct.unpack_from("<IIII", blob, 4)
    max_value, flags, lanes_log2 = struct.unpack_from("<HBB", blob, 20)
    hdr = MICW_HEADER
    if flags & FLAG_BANDED:
        hdr += 8  # orig_width/orig_height extension (see micw_band_info)
    if len(blob) < hdr + num_strips * MICW_ENTRY:
        raise ValueError("micw: truncated strip table")
    table = [
        struct.unpack_from("<IIIIIII", blob, hdr + s * MICW_ENTRY) for s in range(num_strips)
    ]
    data0 = hdr + num_strips * MICW_ENTRY
    strips = []
    for off, ln, n_soa, n_tok, n_runs, n_same, mode in table:
        start = data0 + off
        if start + ln > len(blob):
            raise ValueError("micw: strip data out of bounds")
        strips.append((blob[start : start + ln], n_soa, n_tok, n_runs, n_same, mode))
    if flags & FLAG_DIRECT:
        predictor = "zzd"
    elif flags & FLAG_AVG_PREDICTOR:
        predictor = "avg"
    else:
        predictor = "zz"
    return width, height, num_strips, strip_h, max_value, predictor, 1 << lanes_log2, strips


def micw_decompress_host(blob: bytes) -> tuple[np.ndarray, int, int]:
    """Host (numpy) MICW decoder: cross-checks the device path.  A copy of
    ``mic_tpu.tpu.strips.micw_decompress_host``; it takes no device."""
    width, height, num_strips, strip_h, max_value, gpred, _lanes, strips = micw_parse(blob)
    _thr, delim = delta_params(max_value)
    mid = _rle_mid(max_value)
    out = np.empty(width * height, dtype=np.uint16)
    for i, (b, _n_soa, n_tok, n_runs, n_same, mode) in enumerate(strips):
        y0 = i * strip_h
        sh = min(strip_h, height - y0)
        pred = strip_predictor(gpred, mode)
        if pred is None:
            if mode == STRIP_MODE_CONST:
                out[y0 * width : (y0 + sh) * width] = np.frombuffer(b, dtype="<u2", count=1)[0]
            else:
                out[y0 * width : (y0 + sh) * width] = np.frombuffer(b, dtype="<u2", count=width * sh)
            continue
        if pred in _DIRECT_PREDS or pred in _RLE_DIRECT_PREDS:
            if pred in _RLE_DIRECT_PREDS:
                soa = mict_decode_numpy(b)
                syms = soa_expand(soa, n_runs, n_same, MID_DIRECT)
                if len(syms) != n_tok:
                    raise ValueError("micw: r-mode token count mismatch")
                syms = syms[: width * sh]
                pred = {"zzr": "zzd", "vdr": "vdd", "pdr": "pdd"}[pred]
            else:
                syms = mict_decode_numpy(b)[: width * sh].astype(np.uint16)
            u = syms.astype(np.uint32)
            dz = ((u >> 1) ^ (-(u & 1) & 0xFFFFFFFF)).astype(np.uint16).astype(np.int64)
            if pred == "pdd":
                img = np.cumsum(dz.reshape(sh, width), axis=1) & 0xFFFF
                img = np.cumsum(img, axis=0) & 0xFFFF
            else:
                axis = 1 if pred == "zzd" else 0
                img = np.cumsum(dz.reshape(sh, width), axis=axis) & 0xFFFF
            out[y0 * width : (y0 + sh) * width] = img.astype(np.uint16).ravel()
            continue
        soa = mict_decode_numpy(b)
        tokens = soa_expand(soa, n_runs, n_same, mid)
        if len(tokens) != n_tok:
            raise ValueError("micw: token count mismatch")
        values, is_raw = parse_escaped(tokens[1:], delim, width * sh)
        out[y0 * width : (y0 + sh) * width] = predictor_decode(
            values, is_raw, width, sh, int(tokens[0]), "zz" if pred == "zz" else "avg"
        ).ravel()
    return _unband(out, width, height, blob)


def _pow2_at_least(x: int, lo: int = 1) -> int:
    b = lo
    while b < x:
        b *= 2
    return b


def _runs_floor(pred: str, width: int, strip_h: int) -> int:
    """Floor for the r-modes' run-count bucket: px/64, pow2 (0 for the
    other modes)."""
    if pred not in _RLE_DIRECT_PREDS:
        return 0
    return 128 * _pow2_at_least((width * strip_h) // 8192, 1)


def _rle_sizing(strips, pred: str, width: int, strip_h: int):
    """(maxr, out_rows) of a group of r-mode strips (table entries), as
    ``mic_tpu`` sizes its fused r-kernel launches: the run-table capacity,
    a power of two >= 512 covering every strip's runs plus one table row
    (its maxr / 128 rows also set the least entropy steps), and the output
    rows, a power of two >= 8 covering every strip's pixels."""
    runs = max(_runs_floor(pred, width, strip_h),
               128 * _pow2_at_least((max(st[3] for st in strips) + 128) // 128))
    return max(runs, 512), _pow2_at_least(-(-max(st[2] for st in strips) // 128), 8)


def _post_params(pred: str, mid: int, delim: int) -> tuple[int, int]:
    """(mid_count, delim) as the post path reads them: the direct modes
    use neither (zeroed), the r-modes the format constant MID_DIRECT, the
    escaped modes the container's (from its maxValue)."""
    if pred in _DIRECT_PREDS:
        return 0, 0
    if pred in _RLE_DIRECT_PREDS:
        return MID_DIRECT, 0
    return mid, delim


def _post_sizing(strips, pred: str, width: int, strip_h: int):
    """(max_runs, max_tokens) of a post bucket's strips (table entries),
    as ``mic_tpu`` sizes its post programs: 128 each for the direct
    modes, else powers of two (x128) covering every strip's runs and
    tokens plus one row, the runs floored at ``_runs_floor``."""
    if pred in _DIRECT_PREDS:
        return 128, 128
    runs = max(_runs_floor(pred, width, strip_h),
               128 * _pow2_at_least((max(st[3] for st in strips) + 128) // 128))
    return runs, 128 * _pow2_at_least((max(st[2] for st in strips) + 128) // 128)


def _strip_bucket(p, st, pred: str, width: int, strip_h: int, dense: bool,
                  max_value: int = 0, scan: bool = False):
    """Bucket key of one entropy strip (parsed MICT ``p``, table entry
    ``st``; ``dense`` is the container's FLAG_RDENSE, ``max_value`` its
    maxValue, which sets the escaped modes' post constants).  A strip
    whose lanes are not 128, an FF 41 strip above tableLog 12, and with
    ``scan`` every strip, keys a scan bucket.  Raises ValueError for a
    table entry whose counts would size the decode past the strip, and
    for a scan strip past the lanes kernel's LANES_MAX lanes."""
    is_alias = p[7] is not None
    # The sizing reads the table entry: a dishonest one must not make the
    # run tables, tokens or output outgrow the strip.
    if pred in _RLE_DIRECT_PREDS and (st[3] > p[2] or st[2] > width * strip_h):
        raise ValueError(f"micw: {pred} strip claims {st[3]} runs in {p[2]} "
                         f"symbols and {st[2]} of its {width * strip_h} pixels")
    if pred in ("zz", "avg") and (st[3] > p[2] or st[2] > 2 * width * strip_h + 1):
        raise ValueError(f"micw: {pred} strip claims {st[3]} runs in {p[2]} "
                         f"symbols and {st[2]} tokens for its {width * strip_h} pixels")
    mid = delim = 0
    if pred in ("zz", "avg"):
        mid, delim = _rle_mid(max_value), delta_params(max_value)[1]
    if scan or p[0] != 128 or (is_alias and p[1] > ALIAS_TABLE_LOG):
        if p[0] > LANES_MAX:
            raise ValueError(f"micw: a strip of {p[0]} lanes (the lanes kernel takes "
                             f"{LANES_MAX})")
        b = _pow2_at_least(-(-p[2] // p[0]), 8)
        return ("scan", p[0], b, pred, width, strip_h, *_post_params(pred, mid, delim))
    packed = is_alias or (p[1] <= 12 and np.count_nonzero(p[5]) <= MAX_ALPHABET)
    # Padded step count, a power of two >= 8: strips of similar size share
    # a launch, so short strips do not pad to the longest one.
    b = _pow2_at_least(-(-p[2] // 128), 8)
    a = "a" if is_alias else ""
    whole = width % 128 == 0 and (pred not in ("vdd", "vdr")
                                  or width // 128 in (1, 2, 4, 8))
    if packed and whole and pred in _RLE_DIRECT_PREDS:
        return (a + pred, b, width, strip_h, dense)
    if packed and whole and pred in _DIRECT_PREDS:
        if pred == "pdd":
            return (a + "pdd", b, width, strip_h)  # the column cumsum needs the geometry
        if pred == "vdd":
            return (a + "vdd", b, width)
        return (a + "zzd", b)  # widths mix through the ws operand
    form = "alias" if is_alias else ("packed" if packed else "two_table")
    return ("post", form, pred, b, width, strip_h, *_post_params(pred, mid, delim))


class _Bucket:
    """One bucket: device operands, a kernel wrapper and its arguments
    and, for pdd and pdr, the (width, strip_h) of the column prefix sum
    (pdd's in the kernel: ``pdd_ws`` chunks a row, or 0 where the row
    leaves the kernel no room for its column carry); for a post bucket,
    the symbols-out wrapper (a scan bucket: the lanes kernel's) and the post
    function's arguments; a fused scan bucket's kwargs carry its inverse
    and geometry, and it has no post stage."""

    def __init__(self, key, entries, device):
        self.n = len(entries)
        self.geom = self.post = None
        self.pdd_ws = 0
        self.alias_strips = 0  # strips whose bucket tables the lanes kernel reads
        if key[0] == "post":
            self._init_post(key, entries, device)
            return
        if key[0] == "scan":
            with trace.span("plan.tables"):
                built = build_lane_operands([e[0] for e in entries], min_steps=key[2])
                self.fn = rans_decode_lanes
                self.kwargs = dict(steps=built[12])
                self.alias_strips = int((built[11] >= 0).sum())
                lanes, pred, width, strip_h = key[1], key[3], key[4], key[5]
                fused = fused_strip_fits(lanes, pred, width, bool((built[8] >= 0).any()),
                                         self.alias_strips > 0)
            with trace.span("plan.upload"):
                self.ops = lane_tensors(built[:12], device)
            if fused:
                # the direct inverse in the lanes kernel: no post stage
                self.kwargs.update(inverse=pred, width=width, strip_h=strip_h)
                return
            self._set_post(entries, *key[3:], device)
            return
        kind, steps = key[0], key[1]
        with trace.span("plan.tables"):
            S = len(entries)
            parsed = [e[0] for e in entries]
            ws = np.zeros((S, 128), np.uint32)
            ws[:] = np.array([e[1] for e in entries], np.uint32)[:, None] // 128
            pred = kind.lstrip("a")
            self.geom = (key[2], key[3]) if pred in ("pdd", "pdr") else None
            self.pdd_ws = key[2] // 128 if pred == "pdd" else 0
            vdd_ws = key[2] // 128 if pred in ("vdd", "vdr") else 0
            rle = {}
            if pred in _RLE_DIRECT_PREDS:
                maxr, out_rows = _rle_sizing([e[2] for e in entries], pred, key[2], key[3])
                steps = max(steps, maxr // 128)
                counts = np.array([[e[2][3], e[2][4]] for e in entries], np.uint32)
                runs = tuple(np.repeat(counts[:, i:i + 1], 128, axis=1) for i in (0, 1))
                rle = dict(out_rows=out_rows, maxr=maxr, dense=key[4])
            if kind.startswith("a"):
                built = build_alias_bucket_tables(parsed, min_steps=steps)
                esc = any(len(p[7][1]) for p in parsed)
                self.fn = rans_decode_rle_alias if rle else rans_decode_alias
                host = built[:9] + (ws,) + (runs if rle else ())
                self.kwargs = dict(steps=built[10], vdd_ws=vdd_ws, esc=esc, **rle)
            else:
                tl = max(max(p[1] for p in parsed), 7)
                built = build_packed_tables(parsed, tl, min_steps=steps)
                if built is None:  # _strip_bucket rejects what the tables would
                    raise RuntimeError(f"micw: packed tables refused bucket {key}")
                self.fn = rans_decode_rle if rle else rans_decode_zzd
                host = built[:6] + (ws,) + (runs if rle else ())
                self.kwargs = dict(steps=built[7], vdd_ws=vdd_ws, **rle)
        with trace.span("plan.upload"):
            self.ops = to_device(host, device)
        if self.pdd_ws and not direct_strip_fits(*self.launch):
            # A row too wide for the column carry beside the ring and
            # tables: the kernel's row prefix, the column sum in finish.
            self.pdd_ws = 0

    def _init_post(self, key, entries, device):
        form, pred, steps, width, strip_h, mid, delim = key[1:]
        parsed = [e[0] for e in entries]
        with trace.span("plan.tables"):
            if form == "alias":
                built = build_alias_bucket_tables(parsed, min_steps=steps)
                ws = np.zeros((self.n, 128), np.uint32)  # read only by the fused form
                self.fn = rans_decode_alias
                host = built[:9] + (ws,)
                self.kwargs = dict(steps=built[10], fused=False,
                                   esc=any(len(p[7][1]) for p in parsed))
            else:
                tl = max(max(p[1] for p in parsed), 7)  # the Pallas sweeps' floor
                if form == "packed":
                    built = build_packed_tables(parsed, tl, min_steps=steps)
                    self.fn = rans_decode_packed
                else:
                    built = build_pallas_tables(parsed, tl, min_steps=steps)
                    self.fn = rans_decode
                host = built[:6]
                self.kwargs = dict(steps=built[7])
        with trace.span("plan.upload"):
            self.ops = to_device(host, device)
        self._set_post(entries, pred, width, strip_h, mid, delim, device)

    def _set_post(self, entries, pred, width, strip_h, mid, delim, device):
        """The post stage's arguments and the strips' table entries."""
        with trace.span("plan.tables"):
            table = [e[2] for e in entries]
            max_runs, max_tokens = _post_sizing(table, pred, width, strip_h)
            meta = torch.tensor([[t[2], t[3], t[4]] for t in table], dtype=torch.int64)
        with trace.span("plan.upload"):
            self.meta = meta.to(device)
        self.post = dict(width=width, strip_h=strip_h, max_runs=max_runs,
                         max_tokens=max_tokens, mid_count=mid, delim=delim, predictor=pred)

    @property
    def launch(self):
        """(wrapper, operands, keyword arguments) of the bucket's launch;
        a pdd bucket's arguments add ``pdd_ws``, for the groups launch."""
        kw = dict(self.kwargs, pdd_ws=self.pdd_ws) if self.pdd_ws else self.kwargs
        return self.fn, self.ops, kw

    def __call__(self) -> torch.Tensor:
        if self.post is None and self.fn in _DIRECT_FNS:
            (out,) = rans_decode_direct_groups([self.launch])
        else:
            out = self.fn(*self.ops, **self.kwargs)
        return self.finish(out)

    def finish(self, out: torch.Tensor) -> torch.Tensor:
        """The bucket's result from its launch's output: the post path, or
        pdd's rows (the kernel summed the columns) or the column prefix sum
        (pdr, and pdd with ``pdd_ws`` 0), or the output as it is."""
        if self.post is not None:
            return post_decode(out, self.meta, **self.post)
        out = out.reshape(self.n, -1)
        if self.geom is None:
            return out
        w, sh = self.geom
        need = w * sh
        if self.pdd_ws:
            return _fit_columns(out, w, need)
        if out.shape[1] < need:  # a short last strip of a taller bucket
            out = torch.nn.functional.pad(out, (0, need - out.shape[1]))
        img = (out[:, :need].to(torch.int32) & 0xFFFF).reshape(self.n, sh, w)
        return _as_i16(torch.cumsum(img, dim=1, dtype=torch.int32)).reshape(self.n, -1)


def _fit_columns(out: torch.Tensor, w: int, need: int) -> torch.Tensor:
    """A pdd bucket's column-summed output (int16 [n, cols]) cut or grown
    to ``need`` = w * strip_h pixels a strip.  A short strip of a taller
    bucket (cols < need) grows as its column sums would over zero rows:
    each column keeps its last value, and a column with none is 0."""
    cols = out.shape[1]
    if cols >= need:
        return out[:, :need]
    p = torch.arange(cols, need, device=out.device)
    c = p % w
    last = c + w * ((cols - 1 - c) // w)  # the column's last position < cols
    grown = torch.where(last >= 0, out[:, last.clamp(min=0)], torch.zeros_like(out[:, :1]))
    return torch.cat([out, grown], dim=1)


def _route(key, bucket) -> str:
    """The route of a bucket's strips, as the counters ``strips.<route>``
    name it: ``direct``, ``rle``, ``post`` (an entropy kernel, then the
    post kernel), ``scan_fused`` or ``scan_post``."""
    if key[0] == "scan":
        return "scan_post" if bucket.post is not None else "scan_fused"
    if bucket.post is not None:
        return "post"
    return "rle" if bucket.fn in _RLE_FNS else "direct"


def _work_bytes(buckets: dict, sizes: dict) -> dict:
    """The bytes each kernel of a plan's run must move, set by the format
    and not by any kernel's operands: for each strip its MICT stream read
    once and its pixels (2 bytes each) written once, or, for a strip whose
    symbols go on to the post stage, its symbols (2 bytes each) written
    once by the entropy kernel and read once by the post kernel, which
    writes the pixels.  ``sizes`` holds each bucket's MICT bytes, pixels
    and symbols.  Keys: the kernels the plan runs, of ``direct``, ``rle``,
    ``lanes`` and ``post``."""
    work: dict[str, int] = {}
    for k, b in buckets.items():
        mict, pixels, symbols = sizes[k]
        kernel = ("lanes" if b.fn is rans_decode_lanes
                  else "rle" if b.fn in _RLE_FNS else "direct")
        if b.post is None:
            work[kernel] = work.get(kernel, 0) + mict + 2 * pixels
        else:
            work[kernel] = work.get(kernel, 0) + mict + 2 * symbols
            work["post"] = work.get("post", 0) + 2 * symbols + 2 * pixels
    return work


class MicwDecodePlan:
    """A staged decode of a fixed batch of MICW blobs on ``device``.

    Host work (parsing, table building, the copy of operands to the
    device) runs once here; :meth:`run` executes only the bucket
    launches and returns device-resident outputs; :meth:`assemble`
    copies a run's outputs back to per-image host arrays, and
    :meth:`assemble_device` gathers them into per-image tensors that stay
    on ``device``.

    ``scan=True`` routes every entropy strip through the scan tier (the
    lanes kernel, with the direct inverse fused or then the post stage),
    as ``mic_tpu``'s
    ``micw_decompress_device`` and ``micw_decode_batch`` do; by default a
    strip takes the scan tier only where ``mic_tpu``'s plan does (lanes
    != 128, FF 41 above tableLog 12).
    """

    def __init__(self, blobs, device, scan: bool = False):
        with trace.span("plan.stage") as sp:
            self._stage(blobs, device, scan)
            if sp is not None:
                sp.attrs.update(strips=sum(len(k) for k in self.keys_per_blob),
                                buckets=len(self.buckets))

    def _stage(self, blobs, device, scan: bool):
        self.device = torch.device(device)
        self.blobs = list(blobs)
        self.metas = []  # (width, height, num_strips, strip_h) per blob
        self.keys_per_blob = []  # per strip: ("raw", i) or (bucket key, row)
        self.raw_strips = []
        entries: dict[tuple, list] = {}
        # Replicated batches pass the same blob object many times: parse
        # each distinct container and strip once.
        parse_memo: dict[int, tuple] = {}
        mict_memo: dict[int, tuple] = {}
        sizes: dict[tuple, list] = {}  # per bucket: MICT bytes, pixels, symbols
        with trace.span("plan.parse"):
            for blob in self.blobs:
                parsed_c = parse_memo.get(id(blob))
                if parsed_c is None:
                    parsed_c = parse_memo[id(blob)] = micw_parse(blob)
                width, height, num_strips, strip_h, mv, gpred, _lanes, strips = parsed_c
                dense = bool(blob[22] & FLAG_RDENSE)
                self.metas.append((width, height, num_strips, strip_h))
                keys = []
                for i, st in enumerate(strips):
                    pred = strip_predictor(gpred, st[5])
                    if pred is None:
                        self.raw_strips.append(st)
                        keys.append(("raw", len(self.raw_strips) - 1))
                        continue
                    p = mict_memo.get(id(st[0]))
                    if p is None:
                        p = mict_memo[id(st[0])] = mict_parse(st[0])
                    bk = _strip_bucket(p, st, pred, width, strip_h, dense, mv, scan)
                    bucket = entries.setdefault(bk, [])
                    keys.append((bk, len(bucket)))
                    bucket.append((p, width, st))
                    size = sizes.get(bk)
                    if size is None:
                        size = sizes[bk] = [0, 0, 0]
                    size[0] += len(st[0])
                    size[1] += width * min(strip_h, height - i * strip_h)
                    size[2] += p[2]
                self.keys_per_blob.append(keys)
        self.buckets = {k: _Bucket(k, e, self.device) for k, e in entries.items()}
        cuda = self.device.type == "cuda"
        with trace.span("plan.upload"):  # the packings, from the buckets' launches
            # The direct buckets and the post buckets' entropy stages run as
            # one launch of the direct kernel, the r-mode buckets as one of
            # the r-kernel, the scan buckets' entropy stages as one of the
            # lanes kernel.
            self._direct_keys = [k for k, b in self.buckets.items() if b.fn in _DIRECT_FNS]
            self._direct_groups = [self.buckets[k].launch for k in self._direct_keys]
            self._rle_keys = [k for k, b in self.buckets.items() if b.fn in _RLE_FNS]
            self._rle_groups = [self.buckets[k].launch for k in self._rle_keys]
            self._scan_keys = [k for k, b in self.buckets.items() if b.fn is rans_decode_lanes]
            self._scan_groups = [self.buckets[k].launch for k in self._scan_keys]
            # Every post bucket's post stage (the post path's and the
            # unfused scan buckets') as one launch of the post kernel.
            self._post_keys = [k for k, b in self.buckets.items() if b.post is not None]
            self._post_groups = [(self.buckets[k].meta, self.buckets[k].post)
                                 for k in self._post_keys]
            self.direct_packing = (DirectPacking(self._direct_groups)
                                   if self._direct_groups and cuda else None)
            self.rle_packing = (RlePacking(self._rle_groups)
                                if self._rle_groups and cuda else None)
            self.scan_packing = (LanesPacking(self._scan_groups)
                                 if self._scan_groups and cuda else None)
            self.post_packing = (PostPacking(self._post_groups, self.device)
                                 if self._post_groups else None)
        self.work_bytes = _work_bytes(self.buckets, sizes)
        # each kernel's launches a run on the card (none on the CPU)
        self._launches = {
            "direct": int(self.direct_packing is not None),
            "rle": int(self.rle_packing is not None),
            "lanes": self.scan_packing.n_launches if self.scan_packing else 0,
            "post": len(self.post_packing.parts) if self.post_packing and cuda else 0}
        self._gather = None  # assemble_device's copy lists, built at its first call
        for k, b in self.buckets.items():
            trace.count(f"strips.{_route(k, b)}", b.n)
            if k[0] == "scan":
                trace.count("strips.scan_alias_buckets", b.alias_strips)
        for st in self.raw_strips:
            trace.count("strips.const" if st[5] == STRIP_MODE_CONST else "strips.raw")

    def run(self) -> dict:
        """Launch every bucket (the direct buckets and the post buckets'
        entropy stages together, one launch, the r-mode buckets together,
        one launch, and the scan buckets together, one launch a form of
        the lanes kernel), then the post stage of the post buckets and the
        unfused scan buckets together, one launch of ``csrc/post.cu``
        (``post.post_decode_groups``; ``post.post_batch`` is its plain twin,
        which only CPU tensors take); returns
        {bucket key: int16 [S, cols] device tensor} (bit-views of the u16
        pixels).  Traced, each kernel's call is a span ``run.<kernel>``
        (its ``launches`` on the card an attribute) and adds the kernel's
        ``work_bytes`` to the counter ``work_bytes.<kernel>``."""
        with trace.span("plan.run"):
            outs = {}
            if self._direct_keys:
                with trace.span("run.direct") as sp:
                    outs.update(zip(self._direct_keys, rans_decode_direct_groups(
                        self._direct_groups, self.direct_packing)))
                    if sp is not None:
                        sp.attrs["launches"] = self._launches["direct"]
                trace.count("work_bytes.direct", self.work_bytes["direct"])
            if self._rle_keys:
                with trace.span("run.rle") as sp:
                    outs.update(zip(self._rle_keys, rans_decode_rle_groups(
                        self._rle_groups, self.rle_packing)))
                    if sp is not None:
                        sp.attrs["launches"] = self._launches["rle"]
                trace.count("work_bytes.rle", self.work_bytes["rle"])
            if self._scan_keys:
                with trace.span("run.lanes") as sp:
                    outs.update(zip(self._scan_keys, rans_decode_lanes_groups(
                        self._scan_groups, self.scan_packing)))
                    if sp is not None:
                        sp.attrs["launches"] = self._launches["lanes"]
                trace.count("work_bytes.lanes", self.work_bytes["lanes"])
            done = {}
            if self._post_keys:
                with trace.span("run.post") as sp:
                    done = dict(zip(self._post_keys, post_decode_groups(
                        [(outs[k], *g) for k, g in zip(self._post_keys, self._post_groups)],
                        self.post_packing)))
                    if sp is not None:
                        sp.attrs["launches"] = self._launches["post"]
                trace.count("work_bytes.post", self.work_bytes["post"])
            with trace.span("run.finish"):
                return {k: done[k] if k in done else b.finish(outs[k])
                        for k, b in self.buckets.items()}

    def _strip_rows(self, bi: int):
        """(y0, rows, key, index) of every strip of blob ``bi``."""
        width, height, _ns, strip_h = self.metas[bi]
        for i, (k, idx) in enumerate(self.keys_per_blob[bi]):
            y0 = i * strip_h
            yield y0, min(strip_h, height - y0), k, idx

    def _raw_pixels(self, idx: int, n: int) -> np.ndarray:
        st = self.raw_strips[idx]
        if st[5] == STRIP_MODE_CONST:
            return np.full(n, np.frombuffer(st[0], dtype="<u2", count=1)[0], np.uint16)
        return np.frombuffer(st[0], dtype="<u2", count=n)

    def _segments(self, expected_by_blob: dict):
        """The host half of verification: (the mismatching pixels of the
        raw and constant strips, counted on the host; per bucket key, each
        row's expected pixels).  ``expected_by_blob`` is {blob index:
        pixels in image order}."""
        segs: dict = {}
        host = 0
        for bi, expected in expected_by_blob.items():
            expected = np.asarray(expected, dtype=np.uint16).ravel()
            width, height = self.metas[bi][:2]
            info = micw_band_info(self.blobs[bi])
            if info is not None:
                expected = band_split(expected, info[0], info[1])[0]
            if expected.size != width * height:
                raise ValueError(f"blob {bi}: expected {width * height} pixels, got {expected.size}")
            for y0, sh, k, idx in self._strip_rows(bi):
                seg = expected[y0 * width : (y0 + sh) * width]
                if k == "raw":
                    host += int(np.count_nonzero(self._raw_pixels(idx, seg.size) != seg))
                else:
                    segs.setdefault(k, {})[idx] = seg
        return host, segs

    def _mismatches(self, decoded: dict, expected_by_blob: dict) -> int:
        """Count of decoded pixels that differ from ``expected_by_blob``
        ({blob index: pixels in image order}).  Bucket outputs compare on
        their device against their expected rows (rows of other blobs have
        valid length 0) by :func:`verify.bucket_mismatches_plain`; raw
        strips compare on the host."""
        host, segs = self._segments(expected_by_blob)
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        for k, rows in segs.items():
            exp, valid = expected_rows(rows, decoded[k].shape[0])
            total += bucket_mismatches_plain(
                decoded[k], torch.from_numpy(exp.view(np.int16)).to(self.device),
                torch.from_numpy(valid).to(self.device))
        return host + int(total)

    def make_timed_runner(self, expected_per_blob):
        """A runner that decodes the plan ``n`` times back to back and
        verifies the first decode on the device: the counterpart of
        ``mic_tpu``'s ``MicwDecodePlan.make_timed_runner``.

        At build time the expected pixels (``expected_per_blob``, blob
        order) are staged on the plan's device once per bucket, rows padded
        to the bucket's widest segment, with each row's valid length
        (:func:`verify.expected_rows`) and a map from the bucket's rows to
        them: the strips of one blob object checked against one expected
        object are staged once however often the batch repeats the pair
        (``mic_tpu`` stages one period where the whole batch repeats one
        blob).  Raw and constant strips are checked once, on the host.
        ``runner(n)`` calls :meth:`run` ``n`` times on the current stream;
        after each run one :func:`verify.count_mismatches` call (on the card
        one launch of ``csrc/verify.cu``) adds each bucket's ``out[0, :8]``
        (u16 values) to a probe and, after the first, the mismatching pixels
        of every bucket to a count.  It returns (mismatches, probe) as 0-d int64
        device tensors, with no host sync: the caller times it with CUDA
        events and reads both.  ``runner.packing`` is the
        :class:`verify.MismatchPacking` it compares with.

        Returns None where ``mic_tpu``'s does: its one case here is a raw
        or constant strip whose pixels differ from the expected (the port
        stages no blob through a fallback)."""
        host, segs = self._segments(dict(enumerate(expected_per_blob)))
        if host:
            return None
        # a row's source: (blob object, expected object, first image row)
        source = {k: [None] * b.n for k, b in self.buckets.items()}
        for bi, (blob, exp) in enumerate(zip(self.blobs, expected_per_blob)):
            for y0, _sh, k, idx in self._strip_rows(bi):
                if k != "raw":
                    source[k][idx] = (id(blob), id(exp), y0)
        staged = []
        for k, b in self.buckets.items():
            if k not in segs:
                staged.append(None)
                continue
            distinct, rows = {}, {}
            rowmap = np.empty(b.n, np.int32)
            for idx, src in enumerate(source[k]):
                if src not in distinct:
                    distinct[src] = len(distinct)
                    if idx in segs[k]:
                        rows[distinct[src]] = segs[k][idx]
                rowmap[idx] = distinct[src]
            staged.append((*expected_rows(rows, len(distinct)), rowmap))
        packing = MismatchPacking([b.n for b in self.buckets.values()], staged, self.device)

        def runner(n: int):
            acc = torch.zeros(2, dtype=torch.int64, device=self.device)
            for i in range(n):
                outs = self.run()
                count_mismatches(packing, outs.values(), acc, compare=i == 0)
                del outs  # free this run's outputs before the next run allocates its own
            return acc[0], acc[1]

        runner.packing = packing
        return runner

    def verify_batch(self, decoded: dict, expected_per_blob) -> int:
        """Mismatching pixel count of EVERY blob of the batch (0 = all
        bit-exact); ``expected_per_blob`` is in blob order."""
        return self._mismatches(decoded, dict(enumerate(expected_per_blob)))

    def verify_against(self, decoded: dict, expected, bi: int = 0) -> int:
        """Mismatching pixel count of blob ``bi`` alone."""
        return self._mismatches(decoded, {bi: expected})

    def assemble(self, decoded: dict):
        """Copy one run's outputs to host pixel arrays, blob order:
        [(pixels u16, width, height)]."""
        host = {k: v.cpu().numpy().view(np.uint16) for k, v in decoded.items()}
        results = []
        for bi, blob in enumerate(self.blobs):
            width, height = self.metas[bi][:2]
            out = np.empty(width * height, dtype=np.uint16)
            for y0, sh, k, idx in self._strip_rows(bi):
                seg = out[y0 * width : (y0 + sh) * width]
                seg[:] = self._raw_pixels(idx, seg.size) if k == "raw" else host[k][idx][: seg.size]
            results.append(_unband(out, width, height, blob))
        return results

    def _gather_plan(self, decoded: dict):
        """The copies :meth:`assemble_device` makes, built at its first
        call: the raw and constant strips' pixels as one tensor on the
        device, the pixel count of the whole batch, and per source (a
        bucket key, or "raw") a pair of index tensors that map blocks of
        ``g`` pixels of the flattened source to blocks of the flat output,
        ``g`` the largest block that divides every segment and offset of
        that source (a strip of 128 rows of 256 pixels is one block)."""
        raw_parts, raw_at = [], 0
        segs: dict = {}  # source -> [(source offset, output offset, pixels)]
        base = 0
        for bi, (width, height, _ns, _sh) in enumerate(self.metas):
            for y0, sh, k, idx in self._strip_rows(bi):
                n = sh * width
                if k == "raw":
                    raw_parts.append(self._raw_pixels(idx, n))
                    segs.setdefault(k, []).append((raw_at, base + y0 * width, n))
                    raw_at += n
                    continue
                cols = decoded[k].shape[1]
                if n > cols:
                    raise ValueError(f"bucket {k}: a strip of {n} pixels in rows of {cols}")
                segs.setdefault(k, []).append((idx * cols, base + y0 * width, n))
            base += width * height
        raw = np.concatenate(raw_parts) if raw_parts else np.zeros(0, np.uint16)
        raw_dev = torch.from_numpy(raw.astype(np.uint16).view(np.int16)).to(self.device)

        def block_index(offs, counts):  # concatenated arange(offs[i], offs[i] + counts[i])
            first = np.cumsum(counts) - counts
            return torch.from_numpy(np.repeat(offs - first, counts)
                                    + np.arange(int(counts.sum()))).to(self.device)

        copies = []
        for k, items in segs.items():
            src_off, dst_off, n = np.array(items, dtype=np.int64).T
            g = int(np.gcd.reduce(np.concatenate([src_off, dst_off, n])))
            copies.append((k, g, block_index(src_off // g, n // g),
                           block_index(dst_off // g, n // g)))
        return raw_dev, base, copies

    def assemble_device(self, decoded: dict):
        """One run's outputs as per-image tensors on the plan's device,
        blob order: [(pixels int16 [width * height] (bit-view of u16),
        width, height)], the same pixels as :meth:`assemble`.  Rows are
        gathered from each bucket's output with one indexed copy, raw and
        constant strips are uploaded once per plan, and banded containers
        are un-banded with torch reshapes."""
        with trace.span("plan.assemble"):
            if self._gather is None:
                with trace.span("assemble.gather_plan"):
                    self._gather = self._gather_plan(decoded)
                trace.count("assemble.gather_plans")
            raw_dev, total, copies = self._gather
            flat = torch.empty(total, dtype=torch.int16, device=self.device)
            with trace.span("assemble.gathers"):
                for k, g, src_index, dst_index in copies:
                    src = raw_dev if k == "raw" else decoded[k].reshape(-1)
                    blocks = src[: src.numel() // g * g].view(-1, g).index_select(0, src_index)
                    flat[: total // g * g].view(-1, g).index_copy_(0, dst_index, blocks)
            with trace.span("assemble.images", images=len(self.blobs)):
                results, base = [], 0
                for bi, blob in enumerate(self.blobs):
                    width, height = self.metas[bi][:2]
                    px = flat[base : base + width * height]
                    base += width * height
                    info = micw_band_info(blob)
                    if info is not None:
                        ow, oh = info
                        px = px.view(ow // width, oh, width).permute(1, 0, 2).reshape(-1)
                        width, height = ow, oh
                    results.append((px, width, height))
            return results


def micw_decode_many(blobs, device):
    """Decode a batch of MICW images on ``device`` (one plan: a launch of
    the direct kernel, one of the r-kernel, one of the lanes kernel, one
    of the post kernel for the post buckets and unfused scan buckets).
    Images may differ in size and statistics.  Returns a list of (pixels
    u16, width, height), blob order."""
    plan = MicwDecodePlan(blobs, device)
    return plan.assemble(plan.run())


def micw_decompress_device(blob: bytes, device):
    """Decode one MICW container on ``device``: a one-blob plan, the
    counterpart of ``mic_tpu``'s ``micw_decompress_device_pallas`` (not of
    its ``micw_decompress_device``, the scan tier: that is
    :func:`micw_decompress_scan`).  Returns (pixels u16, width, height)."""
    return micw_decode_many([blob], device)[0]


def micw_decompress_scan(blob: bytes, device):
    """Decode one MICW container on ``device`` with every entropy strip in
    the scan tier (the lanes kernel, its direct modes fused), the counterpart
    of ``mic_tpu``'s ``micw_decompress_device``.  Returns (pixels u16,
    width, height)."""
    plan = MicwDecodePlan([blob], device, scan=True)
    return plan.assemble(plan.run())[0]


def micw_decode_batch(blobs, device) -> list[np.ndarray]:
    """Decode many MICW containers on ``device`` with every entropy strip
    in the scan tier, the strips of all images pooled into one launch of
    the lanes kernel: the counterpart of ``mic_tpu``'s
    ``micw_decode_batch``.  Returns each image's pixels (u16, un-banded)."""
    plan = MicwDecodePlan(blobs, device, scan=True)
    return [px for px, _w, _h in plan.assemble(plan.run())]
