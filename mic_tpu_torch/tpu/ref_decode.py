"""Device decode of the reference-format containers: MIC1 frames, PICS
strip containers, MIC2 series and MIC3 whole-slide pyramids.

Counterpart of ``mic_tpu.tpu.ref_decode``, with the same entry points
and an added ``device``.  The entropy stage of every frame, strip or
tile plane of a call joins one batch of ``tans_decode``
(``fse_decompress_device_batch``: one kernel launch per coder and state
count; 1-state streams and streams past the kernel's caps decode on the
host, as in ``mic_tpu``).  For MIC1 frames, MIC2 series and MIC3 tiles
the RLE expansion, the predictor inverse, the temporal add chain and the
YCoCg-R inverse stay host numpy, as in ``mic_tpu`` (``ops/deltarle.py``,
``ops/rle.py``, ``ops/predictors.py``, ``ops/color.py``).  Bit-exact
against ``mic_tpu``'s entry points (``tests/test_torch_ref_decode.py``).

PICS containers of the avg kind (every writer of the reference's
``parallelstrips.go``) decode on the card end to end through
:class:`PicsDecodePlan`, a staged plan as ``strips.MicwDecodePlan`` is:
the tANS kernel, then the post kernel's interleaved-RLE route
(``post.py``: ``avg_i``), then the shared device assemble
(``strips.DeviceAssemble``); its answer stays on the card.

* :func:`decompress_frames_device` — single-frame blobs (avg, grad, or
  RLE-only residual);
* :func:`decompress_pics_device` / :func:`decompress_pics_device_many` —
  PICS containers, strips as the batch axis: the avg kind through
  :class:`PicsDecodePlan`, the grad and residual kinds through the
  entropy batch and the host post stage;
* :func:`decompress_mic2_device` / :func:`decompress_mic2_frame_device` —
  MIC2 series, independent or temporal;
* :func:`decompress_wsi_tile_device` / :func:`decompress_wsi_region_device`
  / :func:`decompress_wsi_level_device` — MIC3 tiles, regions and levels.
"""

from __future__ import annotations

import itertools
import struct

import numpy as np
import torch

from .. import trace
from ..models.rgb import PLANE_COMPRESSED, PLANE_CONSTANT, PLANE_CONSTANT_ZERO, PLANE_RAW
from ..ops.color import ycocgr_inverse
from ..ops.deltarle import delta_rle_decompress, grad_delta_rle_decompress
from ..ops.fse_codec import fse_decompress_auto
from ..ops.predictors import temporal_delta_decode
from ..ops.rle import rle_decompress
from ..parallel.multiframe import extract_frame, read_mic2_header
from ..parallel.strips import pics_strip_blobs
from ..parallel.wsi import _bytes_per_pixel, _u16_to_bytes, extract_tile_blob, read_mic3_header
from .post import PostPacking, interleaved_runs, post_decode_groups
from .strips import DeviceAssemble, gather_plan
from .tans_decode import TansDecodePlan, fse_decompress_device_batch

__all__ = [
    "PicsDecodePlan",
    "decompress_frames_device",
    "decompress_pics_device",
    "decompress_pics_device_many",
    "decompress_mic2_device",
    "decompress_mic2_frame_device",
    "decompress_wsi_tile_device",
    "decompress_wsi_region_device",
    "decompress_wsi_level_device",
]

_INVERSE = {
    "avg": delta_rle_decompress,
    "grad": grad_delta_rle_decompress,
}


def _invert(rle_symbols: np.ndarray, width: int, height: int, kind: str) -> np.ndarray:
    """The host post stage of one frame or strip."""
    if kind == "residual":
        return np.asarray(rle_decompress(rle_symbols))
    try:
        inv = _INVERSE[kind]
    except KeyError:
        raise ValueError(f"ref_decode: unsupported pipeline kind {kind!r}") from None
    return np.asarray(inv(rle_symbols, width, height))


def decompress_frames_device(blobs, dims, device, kind: str = "avg"):
    """Decode a batch of reference single-frame blobs (Delta+RLE+FSE).

    ``dims`` is [(width, height)] per blob; ``kind`` selects the
    predictor pipeline ('avg' = CompressSingleFrame, 'grad' =
    CompressSingleFrameGrad, 'residual' = RLE-only temporal residuals).
    Returns a list of uint16 pixel arrays.
    """
    symbol_streams = fse_decompress_device_batch(list(blobs), device)
    return [
        _invert(syms, w, h, kind)
        for syms, (w, h) in zip(symbol_streams, dims)
    ]


def decompress_pics_device(blob: bytes, device, kind: str = "avg"):
    """Decode one PICS container with its strips as the batch axis
    (:func:`decompress_pics_device_many` of one).  Returns (pixels,
    width, height)."""
    ((px, w, h),) = decompress_pics_device_many([blob], device, kind)
    return px, w, h


def decompress_pics_device_many(blobs, device, kind: str = "avg"):
    """Decode many PICS containers: every strip of every container joins
    one batch, so same-format strips across images share launches.  The
    avg kind runs one :class:`PicsDecodePlan` (one tANS launch, one post
    launch, the assemble on the card) and copies its images back; the grad
    and residual kinds decode their entropy stage in one batch and their
    post stage on the host; another kind raises ValueError.  Returns a
    list of (pixels, width, height)."""
    blobs = list(blobs)
    if kind == "avg":
        plan = PicsDecodePlan(blobs, device)
        return [(px.cpu().numpy().view(np.uint16), w, h)
                for px, w, h in plan.assemble_device(plan.run())]
    pixels, dims = _pics_many(blobs, device, kind)
    return [(px, w, h) for px, (w, h) in zip(pixels, dims)]


def decompress_mic2_device(data: bytes, device):
    """Decode a reference-format MIC2 series (multiframecompress.go:227-265)
    with the entropy stage of every frame (the spatial frame 0 and, in
    temporal mode, every residual frame) in one batch.  Returns (frames,
    header)."""
    hdr, entries, data_offset = read_mic2_header(data)
    blobs = [extract_frame(data, entries, data_offset, i) for i in range(hdr.frame_count)]
    streams = fse_decompress_device_batch(blobs, device)
    if not hdr.temporal:
        frames = [_invert(s, hdr.width, hdr.height, "avg") for s in streams]
        return frames, hdr
    frames = [_invert(streams[0], hdr.width, hdr.height, "avg")]
    for i in range(1, hdr.frame_count):
        residuals = _invert(streams[i], hdr.width, hdr.height, "residual")
        frames.append(temporal_delta_decode(residuals, frames[-1]))
    return frames, hdr


def decompress_mic2_frame_device(data: bytes, frame_idx: int, device):
    """One frame of a MIC2 series (DecompressFrame,
    multiframecompress.go:266): one blob in independent mode; frames
    0..k in one batch, then the add chain, in temporal mode.  Returns
    (pixels, header)."""
    hdr, entries, data_offset = read_mic2_header(data)
    if frame_idx < 0 or frame_idx >= hdr.frame_count:
        raise ValueError(f"frame index {frame_idx} out of range [0, {hdr.frame_count})")
    upto = frame_idx + 1 if hdr.temporal else 1
    first = 0 if hdr.temporal else frame_idx
    blobs = [extract_frame(data, entries, data_offset, i) for i in range(first, first + upto)]
    streams = fse_decompress_device_batch(blobs, device)
    pixels = _invert(streams[0], hdr.width, hdr.height, "avg")
    for s in streams[1:]:
        residuals = _invert(s, hdr.width, hdr.height, "residual")
        pixels = temporal_delta_decode(residuals, pixels)
    return pixels, hdr


def _wsi_tiles_device(data: bytes, hdr, entries, data_offset: int, tile_idxs, device):
    """Decode a set of MIC3 tiles with all their compressed planes in one
    entropy batch.  Returns {global tile index: tile bytes} (full
    tile_w x tile_h, uncropped)."""
    tw, th = hdr.tile_width, hdr.tile_height
    n = tw * th
    rgb8 = hdr.channels == 3 and hdr.bits_per_sample == 8

    # Split every tile into its mode-prefixed plane blobs (rgbcompress.go
    # blob layout for RGB, a single plane for grey).
    plane_lists = {}  # g_idx -> [plane blob, ...]
    batch = []  # inner FSE blobs of PLANE_COMPRESSED planes
    owner = []  # (g_idx, plane_no)
    for g in tile_idxs:
        blob = extract_tile_blob(data, entries, data_offset, g)
        if rgb8:
            if len(blob) < 12:
                raise ValueError("RGB tile blob too small")
            y_len, co_len, cg_len = struct.unpack_from("<III", blob, 0)
            off = 12
            if off + y_len + co_len + cg_len > len(blob):
                raise ValueError("RGB tile blob truncated")
            planes = []
            for ln in (y_len, co_len, cg_len):
                planes.append(blob[off : off + ln])
                off += ln
        else:
            planes = [blob]
        plane_lists[g] = planes
        for p_no, p in enumerate(planes):
            if len(p) and p[0] == PLANE_COMPRESSED:
                batch.append(p[1:])
                owner.append((g, p_no))

    streams = fse_decompress_device_batch(batch, device)
    decoded = {k: delta_rle_decompress(syms, tw, th) for k, syms in zip(owner, streams)}

    out = {}
    for g in tile_idxs:
        planes_px = []
        for p_no, p in enumerate(plane_lists[g]):
            if len(p) == 0:
                raise ValueError("empty plane data")
            mode = p[0]
            if mode == PLANE_CONSTANT_ZERO:
                px = np.zeros(n, dtype=np.uint16)
            elif mode == PLANE_CONSTANT:
                if len(p) < 3:
                    raise ValueError("constant plane data truncated")
                px = np.full(n, struct.unpack_from("<H", p, 1)[0], dtype=np.uint16)
            elif mode == PLANE_COMPRESSED:
                px = decoded[(g, p_no)]
            elif mode == PLANE_RAW:
                if len(p) < 1 + n * 2:
                    raise ValueError("raw plane data truncated")
                px = np.frombuffer(p, dtype="<u2", count=n, offset=1).copy()
            else:
                raise ValueError(f"unknown plane mode {mode}")
            planes_px.append(px)
        if rgb8:
            y, co, cg = planes_px
            if hdr.color_transform:
                out[g] = bytes(ycocgr_inverse(y, co, cg, tw, th))
            else:
                t = np.empty((n, 3), dtype=np.uint8)
                t[:, 0] = y.astype(np.uint8)
                t[:, 1] = co.astype(np.uint8)
                t[:, 2] = cg.astype(np.uint8)
                out[g] = t.tobytes()
        else:
            out[g] = _u16_to_bytes(planes_px[0], hdr.bits_per_sample)
    return out


def decompress_wsi_tile_device(data: bytes, level: int, tile_x: int, tile_y: int,
                               device) -> bytes:
    """One MIC3 tile (DecompressWSITile, wsicompress.go:175); edge tiles
    are cropped to the level's dimensions."""
    hdr, entries, data_offset = read_mic3_header(data)
    if level < 0 or level >= len(hdr.levels):
        raise ValueError(f"MIC3: level {level} out of range [0, {len(hdr.levels)})")
    lv = hdr.levels[level]
    if not (0 <= tile_x < lv.tiles_x and 0 <= tile_y < lv.tiles_y):
        raise ValueError(f"MIC3: tile ({tile_x},{tile_y}) out of range for level {level}")
    g_idx = lv.first_tile_idx + tile_y * lv.tiles_x + tile_x
    tile = _wsi_tiles_device(data, hdr, entries, data_offset, [g_idx], device)[g_idx]
    actual_w = min(hdr.tile_width, lv.width - tile_x * hdr.tile_width)
    actual_h = min(hdr.tile_height, lv.height - tile_y * hdr.tile_height)
    if actual_w == hdr.tile_width and actual_h == hdr.tile_height:
        return tile
    bpp = _bytes_per_pixel(hdr.channels, hdr.bits_per_sample)
    t = np.frombuffer(tile, np.uint8).reshape(hdr.tile_height, hdr.tile_width * bpp)
    return t[:actual_h, : actual_w * bpp].tobytes()


def decompress_wsi_region_device(data: bytes, level: int, x: int, y: int, w: int, h: int,
                                 device) -> bytes:
    """A region of a MIC3 level (DecompressWSIRegion, wsicompress.go:220):
    every tile it touches joins one entropy batch, then the overlaps are
    row-copied."""
    hdr, entries, data_offset = read_mic3_header(data)
    if level < 0 or level >= len(hdr.levels):
        raise ValueError("MIC3: level out of range")
    lv = hdr.levels[level]
    w = min(w, lv.width - x)
    h = min(h, lv.height - y)
    if w <= 0 or h <= 0:
        raise ValueError("MIC3: empty region")
    bpp = _bytes_per_pixel(hdr.channels, hdr.bits_per_sample)

    jobs = []
    for ty in range(y // hdr.tile_height, (y + h - 1) // hdr.tile_height + 1):
        for tx in range(x // hdr.tile_width, (x + w - 1) // hdr.tile_width + 1):
            jobs.append((tx, ty, lv.first_tile_idx + ty * lv.tiles_x + tx))
    tiles = _wsi_tiles_device(data, hdr, entries, data_offset, [g for _tx, _ty, g in jobs],
                              device)

    result = np.zeros(h * w * bpp, dtype=np.uint8).reshape(h, w * bpp)
    for tx, ty, g in jobs:
        t = np.frombuffer(tiles[g], np.uint8).reshape(hdr.tile_height, hdr.tile_width * bpp)
        tx0, ty0 = tx * hdr.tile_width, ty * hdr.tile_height
        tw = min(hdr.tile_width, lv.width - tx0)
        th = min(hdr.tile_height, lv.height - ty0)
        ox0, oy0 = max(x, tx0), max(y, ty0)
        ox1, oy1 = min(x + w, tx0 + tw), min(y + h, ty0 + th)
        if ox1 <= ox0 or oy1 <= oy0:
            continue
        result[oy0 - y : oy1 - y, (ox0 - x) * bpp : (ox1 - x) * bpp] = t[
            oy0 - ty0 : oy1 - ty0, (ox0 - tx0) * bpp : (ox1 - tx0) * bpp
        ]
    return result.tobytes()


def decompress_wsi_level_device(data: bytes, level: int, device) -> bytes:
    """A whole pyramid level in one batch: every tile of the level shares
    the entropy launches."""
    hdr, _entries, _off = read_mic3_header(data)
    if level < 0 or level >= len(hdr.levels):
        raise ValueError("MIC3: level out of range")
    lv = hdr.levels[level]
    return decompress_wsi_region_device(data, level, 0, 0, lv.width, lv.height, device)


def _pics_many(blobs, device, kind: str):
    """PICS containers of the grad or residual kind: the strips' entropy
    stage as one device batch, the post stage on the host."""
    parsed = [pics_strip_blobs(b) for b in blobs]
    flat, owner = [], []
    for i, (_w, _h, _sh, strips) in enumerate(parsed):
        for y0, sh, data in strips:
            flat.append(data)
            owner.append((i, y0, sh))
    streams = fse_decompress_device_batch(flat, device)
    outs = [np.empty(w * h, dtype=np.uint16) for w, h, _sh, _s in parsed]
    for syms, (i, y0, sh) in zip(streams, owner):
        w = parsed[i][0]
        outs[i][y0 * w : (y0 + sh) * w] = _invert(syms, w, sh, kind)
    return outs, [(p[0], p[1]) for p in parsed]


class PicsDecodePlan(DeviceAssemble):
    """A staged decode of a fixed batch of PICS containers of the avg kind
    (the reference's ``CompressParallelStrips`` writers at 2, 4 or 8
    states) on ``device``, as ``strips.MicwDecodePlan`` is of MICW ones.

    ``__init__`` (the span ``plan.stage``) parses the containers
    (``plan.parse``), routes and stages every strip's entropy stream as
    :class:`tans_decode.TansDecodePlan` does (one group a coder and state
    count, one launch; its rows ordered by the strips' geometry, so each
    geometry's strips are consecutive rows), and lays out every
    kernel-routed strip's post stage as an ``avg_i`` bucket a run of rows
    of one geometry (``plan.tables``, ``plan.upload``: the buckets' table
    entries, each strip's symbol count, and a :class:`post.PostPacking`).
    ``run()`` makes one tANS launch and one post launch (``run.tans``,
    ``run.post``) and returns {post bucket: int16 [S, width * strip_h]},
    plus ``"host"``: the pixels of the host-routed strips (a 1-state
    stream or tableLog > 13), decoded on the host inside ``run()`` and
    uploaded in one copy.  :meth:`assemble_device` gives the images on the
    card through ``strips.DeviceAssemble``, the assemble of
    ``MicwDecodePlan``.

    Other kinds raise ValueError (``decompress_pics_device_many`` decodes
    them through its host post stage).  Counters at staging:
    ``strips.pics`` (strips on the card's route) and ``strips.tans_host``
    (strips whose stream decodes on the host); at each run
    ``work_bytes.tans`` (each kernel-routed strip's compressed bytes read
    once and 2 x its symbols written once) and ``work_bytes.post`` (2 x
    its symbols read once and 2 x its pixels written once).
    """

    def __init__(self, blobs, device, kind: str = "avg"):
        if kind != "avg":
            raise ValueError(f"PicsDecodePlan decodes the avg kind, not {kind!r} (the grad and "
                             "residual kinds: decompress_pics_device_many's host post stage)")
        with trace.span("plan.stage") as sp:
            self._stage(blobs, device)
            if sp is not None:
                sp.attrs.update(strips=len(self.strips), buckets=len(self._post_rows))

    def _stage(self, blobs, device):
        self.device = torch.device(device)
        self.blobs = list(blobs)
        with trace.span("plan.parse"):
            parsed = [pics_strip_blobs(b) for b in self.blobs]
            self.metas = [(w, h) for w, h, _sh, _st in parsed]
            self.strips = [(bi, y0, sh, w) for bi, (w, _h, _sh, st) in enumerate(parsed)
                           for y0, sh, _data in st]  # blob, first row, rows, width
            streams = [data for _w, _h, _sh, st in parsed for _y0, _sh2, data in st]
        geometry = [(w, sh) for _bi, _y0, sh, w in self.strips]
        self.tans = TansDecodePlan(streams, self.device, keys=geometry)
        with trace.span("plan.tables"):
            # each post bucket: the rows r0:r1 of tANS group g, one geometry
            self._post_rows, kws, metas = [], [], []
            self.where = [None] * len(self.strips)  # strip -> (post bucket, row)
            for g, (idx, counts, _ops, kw) in enumerate(self.tans.groups):
                cols = kw["steps"] * kw["n_states"]
                r0 = 0
                for (w, sh), rows in itertools.groupby(idx, key=geometry.__getitem__):
                    rows = list(rows)
                    for r, i in enumerate(rows):
                        self.where[i] = (len(self._post_rows), r)
                    self._post_rows.append((g, r0, r0 + len(rows)))
                    kws.append(dict(width=w, strip_h=sh, max_runs=interleaved_runs(cols),
                                    max_tokens=2 * w * sh + 1, mid_count=0, delim=0,
                                    predictor="avg_i"))
                    meta = np.zeros((len(rows), 3), np.int64)
                    meta[:, 0] = counts[r0:r0 + len(rows)]
                    metas.append(meta)
                    r0 += len(rows)
        with trace.span("plan.upload"):
            self._post_groups = [(torch.from_numpy(m).to(self.device), kw)
                                 for m, kw in zip(metas, kws)]
            self.post_packing = (PostPacking(self._post_groups, self.device)
                                 if self._post_groups else None)
        self.host = list(self.tans.host)  # strip indices whose stream decodes on the host
        cuda = self.device.type == "cuda"
        self._launches = {"tans": self.tans.stats["launches"] if cuda else 0,
                          "post": len(self.post_packing.parts) if self.post_packing and cuda
                          else 0}
        kernel = [i for i, wh in enumerate(self.where) if wh is not None]
        symbols = {bi: c for idx, counts, _o, _k in self.tans.groups
                   for bi, c in zip(idx, counts)}
        self.work_bytes = {
            "tans": sum(len(streams[i]) + 2 * symbols[i] for i in kernel),
            "post": sum(2 * symbols[i] + 2 * geometry[i][0] * geometry[i][1] for i in kernel)}
        self._gather = None  # assemble_device's copy lists, built at its first call
        trace.count("strips.pics", len(kernel))
        trace.count("strips.tans_host", len(self.host))

    def _host_pixels(self) -> torch.Tensor:
        """The host-routed strips decoded on the host (their entropy stream,
        RLE and avg inverse) and uploaded: int16 pixels of every such strip
        in turn."""
        parts = []
        for i in self.host:
            _bi, _y0, sh, w = self.strips[i]
            parts.append(_invert(fse_decompress_auto(self.tans.blobs[i]), w, sh, "avg"))
        flat = np.concatenate(parts).astype(np.uint16)
        return torch.from_numpy(flat.view(np.int16)).to(self.device)

    def run(self) -> dict:
        """One tANS launch for every kernel-routed strip, then one post
        launch (``post.post_decode_groups``; its plain twin on the CPU),
        and the host-routed strips' pixels; returns {post bucket: int16
        [S, width * strip_h], "host": int16 pixels} on the device, nothing
        copied to the host.  Traced, the spans ``plan.run`` with
        ``run.tans``, ``run.host`` and ``run.post`` (their ``launches``
        an attribute) and the counters ``work_bytes.tans`` and
        ``work_bytes.post``."""
        with trace.span("plan.run"):
            outs = {}
            if self.tans.groups:
                with trace.span("run.tans") as sp:
                    ent = self.tans.run()
                    if sp is not None:
                        sp.attrs["launches"] = self._launches["tans"]
                trace.count("work_bytes.tans", self.work_bytes["tans"])
            if self.host:
                with trace.span("run.host"):
                    outs["host"] = self._host_pixels()
            if self._post_rows:
                with trace.span("run.post") as sp:
                    outs.update(enumerate(post_decode_groups(
                        [(ent[g][r0:r1], *pg) for (g, r0, r1), pg in zip(self._post_rows,
                                                                         self._post_groups)],
                        self.post_packing)))
                    if sp is not None:
                        sp.attrs["launches"] = self._launches["post"]
                trace.count("work_bytes.post", self.work_bytes["post"])
            return outs

    def _gather_plan(self, decoded: dict):
        """The copies of :meth:`assemble_device` (``strips.gather_plan``):
        each kernel-routed strip's row of its post bucket, each host-routed
        strip's pixels from ``"host"``, into the images in blob order."""
        bases = np.concatenate([[0], np.cumsum([w * h for w, h in self.metas])])
        segs: dict = {}
        host_at = 0  # the host-routed strips lie in turn in "host"
        for i, (bi, y0, sh, w) in enumerate(self.strips):
            n, dst = sh * w, int(bases[bi]) + y0 * w
            if self.where[i] is None:
                segs.setdefault("host", []).append((host_at, dst, n))
                host_at += n
            else:
                k, row = self.where[i]
                segs.setdefault(k, []).append((row * decoded[k].shape[1], dst, n))
        images = [(int(b), w, h, None) for b, (w, h) in zip(bases, self.metas)]
        return gather_plan(segs, np.zeros(0, np.uint16), images, self.device)
