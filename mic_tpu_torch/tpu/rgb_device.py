"""MICW-RGB (MWR3): the device-format RGB / WSI-tile container.

Counterpart of ``mic_tpu.tpu.rgb_device``, with the same entry points and
an added ``device``.  Each plane of an image (Y, zigzag Co, zigzag Cg, all
u16, the reference's ycocgr.go lifting) is a MICW blob, so a batch of RGB
images or WSI tiles decodes through the port's decode kernels in one
``MicwDecodePlan``.

Unlike ``mic_tpu``, which runs the colour transform in numpy on the host
on both sides, the port runs it on ``device`` through
``kernels.ycocgr_forward`` / ``kernels.ycocgr_inverse``.  The decode keeps
the planes on the device from the entropy kernels to the interleaved
bytes (``MicwDecodePlan.assemble_device``, crop, one inverse launch per
distinct image geometry); the encode uploads the interleaved bytes, runs
the forward transform in one launch for the whole batch and brings the
planes back for the padding, the maximum and the host candidates of
``micw_compress_device_many``.  Containers are byte-identical to
``mic_tpu``'s and decodes bit-exact (``tests/test_torch_rgb_device.py``).
``micwr_decompress_host`` is not ported.

Container::

    "MWR3" | width u32 | height u32 | per plane: length u32 | 3 blobs
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .kernels import ycocgr_forward, ycocgr_inverse
from .rans_encode import micw_compress_device_many
from .strips import MicwDecodePlan

__all__ = [
    "micwr_compress",
    "micwr_compress_device",
    "micwr_compress_device_many",
    "micwr_decompress_device",
    "micwr_decode_many",
]

MWR3_MAGIC = b"MWR3"


def _pad_plane(plane: np.ndarray, width: int, height: int):
    """Edge-pad a plane's columns to the next multiple of 128, the width
    the fused decode kernels take (other widths go through the slower
    post path).  Edge replication makes the padded columns' zzd / vdd
    deltas zero.  The MWR3 header keeps the true width; each plane blob's
    own MICW header carries the padded width, and the decode crops."""
    pw = -(-width // 128) * 128
    if pw == width:
        return plane, width
    p2 = np.asarray(plane, np.uint16).reshape(height, width)
    return np.pad(p2, ((0, 0), (0, pw - width)), mode="edge").ravel(), pw


def _crop_plane(plane: torch.Tensor, pw: int, width: int, height: int) -> torch.Tensor:
    """Undo _pad_plane on a decoded plane: [height, width], a view."""
    return plane.reshape(height, pw)[:, :width]


def _forward_planes(rgbs, device):
    """The (y, co, cg) u16 planes of every image of ``rgbs`` ((rgb bytes,
    width, height) each), in order, as host arrays: the interleaved bytes
    of the whole batch go up as one tensor, ``kernels.ycocgr_forward``
    runs once on it, and the planes come back."""
    sizes = [w * h for _rgb, w, h in rgbs]
    flat = []
    for (rgb, _w, _h), n in zip(rgbs, sizes):
        rgb = np.asarray(rgb, dtype=np.uint8).reshape(-1)
        if rgb.size != 3 * n:
            raise ValueError("mwr3: pixel count mismatch")
        flat.append(rgb)
    px = torch.from_numpy(np.concatenate(flat)).to(device).view(-1, 3).to(torch.int16)
    planes = ycocgr_forward(*(px[:, c].contiguous() for c in range(3)))
    y, co, cg = (p.cpu().numpy().view(np.uint16) for p in planes)
    out, at = [], 0
    for n in sizes:
        out.append((y[at : at + n], co[at : at + n], cg[at : at + n]))
        at += n
    return out


def _container(width: int, height: int, blobs) -> bytes:
    out = bytearray()
    out += MWR3_MAGIC
    out += struct.pack("<II", width, height)
    for b in blobs:
        out += struct.pack("<I", len(b))
    return bytes(out) + b"".join(blobs)


def _compress_many(rgbs, device, num_strips: int, predictor: str, entropy: str):
    """MWR3 containers of ``rgbs`` in order: the forward transform, then
    one ``micw_compress_device_many`` call for every plane of every
    image."""
    if not rgbs:
        return []
    images = []
    for (_rgb, width, height), planes in zip(rgbs, _forward_planes(rgbs, device)):
        for p in planes:
            pp, pw = _pad_plane(p, width, height)
            images.append((pp, pw, height, int(pp.max()), num_strips))
    plane_blobs = micw_compress_device_many(images, device, entropy=entropy,
                                            predictor=predictor)
    return [_container(width, height, plane_blobs[3 * i : 3 * i + 3])
            for i, (_rgb, width, height) in enumerate(rgbs)]


def micwr_compress(rgb, width: int, height: int, device, num_strips: int = 0,
                   predictor: str = "auto", entropy: str = "standard") -> bytes:
    """Interleaved RGB bytes -> MWR3 (three MICW plane blobs), the bytes
    ``mic_tpu.tpu.rgb_device.micwr_compress`` writes.  Defaults to the
    ratio-first "auto" trial set; pass "auto-fast" for planes that decode
    through the fused direct kernels only."""
    return _compress_many([(rgb, width, height)], device, num_strips, predictor, entropy)[0]


def micwr_compress_device_many(rgbs, device, entropy: str = "standard"):
    """Encode many RGB images / tiles into MWR3 containers with one
    transform launch and one encode launch for every plane of every image
    (the WSI-ingest shape; zzd pipeline, like ``micw_compress_device``).
    ``rgbs`` is a list of (rgb_bytes, width, height); returns the
    containers in order."""
    return _compress_many(list(rgbs), device, 0, "zzd", entropy)


def micwr_compress_device(rgb, width: int, height: int, device,
                          entropy: str = "standard") -> bytes:
    """Single-image wrapper over micwr_compress_device_many."""
    return micwr_compress_device_many([(rgb, width, height)], device, entropy=entropy)[0]


def _parse(blob: bytes):
    if len(blob) < 24 or blob[:4] != MWR3_MAGIC:
        raise ValueError("not an MWR3 container")
    width, height = struct.unpack_from("<II", blob, 4)
    lens = struct.unpack_from("<III", blob, 12)
    off = 24
    planes = []
    for ln in lens:
        planes.append(blob[off : off + ln])
        off += ln
    return width, height, planes


def _stage(blobs, device):
    """Parse the containers and stage every plane of every image in one
    decode plan: (metas, plan), metas = [(width, height)] in blob order,
    the planes of image i at 3 * i .. 3 * i + 2 of the plan."""
    parsed = [_parse(b) for b in blobs]
    plan = MicwDecodePlan([p for _w, _h, planes in parsed for p in planes], device)
    return [(w, h) for w, h, _planes in parsed], plan


def _run(metas, plan):
    """Decode a staged batch on the plan's device, to the interleaved
    bytes: [(image indices, uint8 [B, height, width, 3] tensor)], one entry
    and one ``kernels.ycocgr_inverse`` launch per distinct (width, height)."""
    decoded = plan.assemble_device(plan.run())
    groups: dict[tuple, list[int]] = {}
    for i, wh in enumerate(metas):
        groups.setdefault(wh, []).append(i)
    out = []
    for (width, height), members in groups.items():
        planes = [decoded[3 * i + j] for i in members for j in range(3)]
        for _px, pw, ph in planes:
            if ph != height or pw < width:
                raise ValueError(f"mwr3: a {pw}x{ph} plane in a {width}x{height} image")
        y, co, cg = (torch.stack([_crop_plane(px, pw, width, height)
                                  for px, pw, _ph in planes[j::3]]) for j in range(3))
        # The channels keep their low 8 bits, as ops.color.ycocgr_inverse's
        # astype(uint8) does.
        rgb = (torch.stack(ycocgr_inverse(y, co, cg), dim=-1) & 0xFF).to(torch.uint8)
        out.append((members, rgb))
    return out


def micwr_decode_many(blobs, device):
    """Decode many RGB images / WSI tiles on ``device``: all 3*N planes
    ride the batched decode launches of one ``MicwDecodePlan`` and stay on
    the device through the crop and ``kernels.ycocgr_inverse`` (one launch
    per distinct image geometry); the interleaved bytes come back in one
    copy per geometry.  Returns [(rgb bytes as a uint8 array, width,
    height), ...] in blob order."""
    metas, plan = _stage(blobs, device)
    out = [None] * len(metas)
    for members, rgb in _run(metas, plan):
        host = rgb.cpu().numpy()
        for n, i in enumerate(members):
            out[i] = (host[n].reshape(-1), *metas[i])
    return out


def micwr_decompress_device(blob: bytes, device):
    return micwr_decode_many([blob], device)[0]
