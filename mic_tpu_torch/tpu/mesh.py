"""Multi-device decode and encode: a kernel's strip (or stream) axis split
over a list of devices.

Counterpart of ``mic_tpu.tpu.mesh``, same names.  There a mesh is a jax
``Mesh`` and each wrapper one ``jit(shard_map(...))`` call; here a mesh is
a tuple of ``torch.device`` (:func:`make_strip_mesh`), and a call cuts
every operand along dim 0 into ``len(mesh)`` equal shards, stages every
shard on its device (the operands through one pinned buffer and one
non-blocking copy, the kernel's descriptors and packing built), then
launches every shard through the port's kernel on its device's current
stream, with nothing that synchronises between the launches, so shards on
different cards overlap.  Strips are independent: no collectives.

Each wrapper returns the shards' outputs as a list in shard order, each
on its own device (the encode wrappers a (words, flags, states) triple a
shard); :func:`gather` concatenates them on one device, a cross-device
copy that the JAX wrappers never make, so the caller chooses when to pay
it.  The wrappers take ``mic_tpu``'s operands (numpy arrays, or tensors in
the port's int32 / int16 bit-views) and keyword arguments; the ones only
the TPU's grid needs (``n_strips`` / ``n_streams``, which JAX derives per
shard, ``asweep``, and the packed kernels' ``table_log``: the port reads
the table widths from the operands) are accepted and dropped.  A shard on
a CUDA device launches the kernel or raises; on the CPU it runs the
kernel's plain twin (the tests' ``[torch.device("cpu")] * n``).

Each one-bucket decode builds its own packing at staging time and
launches through the groups API (``rans_decode_direct_groups``,
``rans_decode_rle_groups``, ``tans_decode_groups``,
``rans_decode_lanes_groups``): the one-bucket wrappers keep one packing
per function, the last call's, which shards called in turn would rebuild
at every call.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import rans_decode as rd
from . import rans_encode as renc
from . import scan_decode as sd
from . import tans_decode as td
from .post import PostPacking

__all__ = [
    "make_strip_mesh",
    "decode_strips_sharded",
    "decode_strips_sharded_pallas",
    "decode_rle_sharded",
    "decode_alias_sharded",
    "decode_tans_sharded",
    "encode_strips_sharded",
    "encode_alias_sharded",
    "gather",
]

_TORCH_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}  # host itemsize -> bit-view
_ALIGN = 256  # bytes between operands in a shard's staging buffer


def make_strip_mesh(devices=None) -> tuple[torch.device, ...]:
    """The devices a sharded call splits over, in shard order: ``devices``
    (a list may repeat a device), or every visible CUDA device.  Without a
    visible CUDA device ``devices`` must be given: the CPU is never taken
    silently."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_strip_mesh: no CUDA device is visible; pass the devices "
                               "(e.g. [torch.device('cpu')] * n)")
        devices = [torch.device("cuda", i) for i in range(n)]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("make_strip_mesh: a mesh needs at least one device")
    return mesh


def gather(shards, device) -> torch.Tensor | tuple:
    """A sharded call's outputs concatenated along dim 0 on ``device``
    (shards of the encode wrappers element by element: a triple)."""
    device = torch.device(device)
    if isinstance(shards[0], tuple):
        return tuple(gather(list(parts), device) for parts in zip(*shards))
    return torch.cat([s.to(device) for s in shards])


def _on(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _upload(arrays, dev: torch.device) -> list[torch.Tensor]:
    """One shard's operands on ``dev``: numpy arrays as bit-views (2-byte
    values int16, 4-byte int32, 8-byte int64) packed into one buffer (pinned
    for a CUDA device) and copied with one non-blocking copy, each at a
    256-byte aligned offset; tensors moved with a non-blocking copy where
    they lie on another device."""
    host = [np.ascontiguousarray(a) for a in arrays if not isinstance(a, torch.Tensor)]
    for a in host:
        if a.dtype.itemsize not in _TORCH_BITS or a.dtype.kind not in "iub":
            raise TypeError(f"operand of dtype {a.dtype}: expected 16-, 32- or 64-bit integers")
    offs = np.cumsum([0] + [-(-a.nbytes // _ALIGN) * _ALIGN for a in host])
    if host:
        buf = torch.empty(int(offs[-1]), dtype=torch.uint8, pin_memory=dev.type == "cuda")
        flat = buf.numpy()
        for a, o in zip(host, offs):
            flat[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        buf = buf.to(dev, non_blocking=True)
    out, k = [], 0
    for a in arrays:
        if isinstance(a, torch.Tensor):
            out.append(a if a.device == dev else a.to(dev, non_blocking=True))
            continue
        h, o = host[k], int(offs[k])
        out.append(buf[o:o + h.nbytes].view(_TORCH_BITS[h.dtype.itemsize]).view(h.shape))
        k += 1
    return out


def _shards(mesh, arrays) -> list[list]:
    """Every operand cut along dim 0 into ``len(mesh)`` equal shards, shard
    by shard; ValueError where ``shard_map`` refuses: a leading dimension
    that does not divide by the mesh size."""
    n = len(mesh)
    if n == 0:
        raise ValueError("empty mesh")
    per = []
    for k, a in enumerate(arrays):
        lead = a.shape[0] if len(a.shape) else 0
        if lead == 0 or lead % n:
            raise ValueError(f"operand {k}: leading dimension {lead} does not divide over "
                             f"{n} devices (pad with replica strips)")
        per.append(lead // n)
    return [[a[i * p:(i + 1) * p] for a, p in zip(arrays, per)] for i in range(n)]


def _kwargs(name: str, static: dict, keep, drop=()) -> dict:
    """The port wrapper's keyword arguments from ``mic_tpu``'s: ``keep``
    pass on, ``drop`` (the TPU grid's) are dropped, others raise."""
    extra = set(static) - set(keep) - set(drop)
    if extra:
        raise TypeError(f"{name}: unexpected keyword arguments {sorted(extra)}")
    return {k: v for k, v in static.items() if k in keep}


def _run(mesh, arrays, stage) -> list:
    """Stage every shard on its device (``stage(dev, operands)`` returns
    the shard's launch), then launch every shard; returns the outputs in
    shard order."""
    launches = []
    for dev, part in zip(mesh, _shards(mesh, arrays)):
        with _on(dev):
            launches.append((dev, stage(dev, part)))
    outs = []
    for dev, launch in launches:
        with _on(dev):
            outs.append(launch())
    return outs


def _direct(fn, static_kw):
    """A one-bucket stager of the direct kernel: the shard's group and its
    packing, launched through ``rans_decode_direct_groups``."""
    def stage(dev, part):
        group = (fn, tuple(_upload(part, dev)), static_kw)
        packing = rd.DirectPacking([group]) if dev.type == "cuda" else None
        return lambda: rd.rans_decode_direct_groups([group], packing)[0]
    return stage


def decode_strips_sharded(mesh, *arrays, **static) -> list[torch.Tensor]:
    """``decode_strip_batch_impl`` (the scan tier's step) with the strip
    axis sharded: ``arrays`` are its 11 numpy operands (those of
    ``build_strip_batch``; leading strip dimension divisible by the mesh
    size), ``static`` its keyword parameters.  Each shard is
    ``scan_decode.decode_strip_batch`` on its device: the lanes kernel
    (``rans_decode_lanes_groups``), the direct inverse fused where
    ``fused_strip_fits``, else then the post kernel (``post.PostPacking``
    staged a shard, ``post.post_decode_groups``, one launch).  Returns int16
    [S / n, width * strip_h] a shard."""
    if len(arrays) != 11:
        raise TypeError(f"decode_strips_sharded: expected 11 operands, got {len(arrays)}")
    arrays = [np.asarray(a) for a in arrays]

    def stage(dev, part):
        host, kw, post = sd.strip_batch_host(*part, **static)
        ops = _upload(host + ((post[0],) if post else ()), dev)
        group = (sd.rans_decode_lanes, tuple(ops[:10]), kw)
        packing = sd.LanesPacking([group]) if dev.type == "cuda" else None
        post_packing = None
        if post is not None:
            post = (ops[10], post[1])  # the meta on the shard's device
            post_packing = PostPacking([post], dev)
        return lambda: sd.strip_batch_post(sd.rans_decode_lanes_groups([group], packing)[0],
                                           post, post_packing)
    return _run(mesh, arrays, stage)


def decode_strips_sharded_pallas(mesh, init, tpk, alpha, words, mask, shift, ws,
                                 **static) -> list[torch.Tensor]:
    """``rans_decode_pallas_zzd`` (the fused FF 57 zzd / vdd decode) with
    the strip axis sharded over ``mesh``: each shard is
    ``rans_decode.rans_decode_zzd``'s bucket, one launch of the direct
    kernel's packed front end on its device.  Returns int16 [S / n, steps,
    128] a shard."""
    kw = _kwargs("decode_strips_sharded_pallas", static, ("steps", "vdd_ws"),
                 ("n_strips", "table_log", "asweep"))
    return _run(mesh, (init, tpk, alpha, words, mask, shift, ws),
                _direct(rd.rans_decode_zzd, kw))


def decode_rle_sharded(mesh, *arrays, **static) -> list[torch.Tensor]:
    """``rans_decode_pallas_rle`` (FF 57 r-mode: rANS, SoA-RLE expand,
    direct inverse) with the strip axis sharded: ``arrays`` are its 9
    operands; each shard is ``rans_decode.rans_decode_rle``'s bucket, one
    launch of the r-kernel on its device.  ``mid_count`` must be the
    r-modes' format constant (``MID_DIRECT``), which the kernel holds.
    Returns int16 [S / n, out_rows, 128] a shard."""
    mid = static.get("mid_count", rd.MID_DIRECT)
    if mid != rd.MID_DIRECT:
        raise ValueError(f"decode_rle_sharded: mid_count {mid}, the r-modes' is {rd.MID_DIRECT}")
    kw = _kwargs("decode_rle_sharded", static, ("steps", "out_rows", "maxr", "vdd_ws", "dense"),
                 ("n_strips", "table_log", "asweep", "mid_count"))

    def stage(dev, part):
        group = (rd.rans_decode_rle, tuple(_upload(part, dev)), kw)
        packing = rd.RlePacking([group]) if dev.type == "cuda" else None
        return lambda: rd.rans_decode_rle_groups([group], packing)[0]
    return _run(mesh, arrays, stage)


def decode_alias_sharded(mesh, *arrays, **static) -> list[torch.Tensor]:
    """``rans_decode_pallas_alias`` (FF 41, any tableLog mix in one call)
    with the strip axis sharded: ``arrays`` are its 10 operands; each shard
    is ``rans_decode.rans_decode_alias``'s bucket, one launch of the
    direct kernel's alias front end on its device.  Returns int16 [S / n,
    steps, 128] a shard (symbols with ``fused=False``)."""
    kw = _kwargs("decode_alias_sharded", static, ("steps", "vdd_ws", "fused", "esc"),
                 ("n_strips",))
    return _run(mesh, arrays, _direct(rd.rans_decode_alias, kw))


def decode_tans_sharded(mesh, init, pos, cnt, tpk, alpha, words,
                        **static) -> list[torch.Tensor]:
    """``tans_decode_pallas`` (reference-format tANS, and FF 08 rANS on its
    tables) with the stream axis sharded: each shard is
    ``tans_decode.tans_decode``'s one group, a packing built at staging
    (which reads the counts back) and one launch of the tANS kernel on its
    device.  Returns int16 [R / n, steps * N / 128, 128] a shard."""
    kw = _kwargs("decode_tans_sharded", static, ("steps", "n_states", "table_log"),
                 ("n_streams", "asweep"))

    def stage(dev, part):
        group = (tuple(_upload(part, dev)), None, kw)
        packing = td.TansPacking([group]) if dev.type == "cuda" else None
        return lambda: td.tans_decode_groups([group], packing)[0]
    return _run(mesh, (init, pos, cnt, tpk, alpha, words), stage)


def _encode(mesh, fn, name: str, arrays, static: dict) -> list[tuple]:
    """A sharded encode: ``widths``, when given, sharded like the operands."""
    kw = _kwargs(name, static, ("steps", "widths"), ("n_strips", "asweep"))
    widths = kw.pop("widths", None)
    arrays = (*arrays, widths) if widths is not None else arrays

    def stage(dev, part):
        ops = _upload(part, dev)
        w = ops.pop() if widths is not None else None
        return lambda: fn(*ops, widths=w, **kw)
    return _run(mesh, arrays, stage)


def encode_strips_sharded(mesh, ranks, te1, te2, count, tls, **static) -> list[tuple]:
    """``rans_encode_pallas`` (the FF 57 device encode) with the strip axis
    sharded: each shard is ``rans_encode.rans_encode``, one launch on its
    device; ``widths`` (int32 [S], the port's per-stream alphabet widths),
    when given, shards like the operands.  Returns a (words, flags,
    states) triple a shard, equal to the unsharded call's rows."""
    return _encode(mesh, renc.rans_encode, "encode_strips_sharded",
                   (ranks, te1, te2, count, tls), static)


def encode_alias_sharded(mesh, ranks, te1, te2, ar1, ar2, count, tls,
                         **static) -> list[tuple]:
    """``rans_encode_pallas_alias`` (the FF 41 device encode) with the
    strip axis sharded, as :func:`encode_strips_sharded`: each shard is
    ``rans_encode.rans_encode_alias``."""
    return _encode(mesh, renc.rans_encode_alias, "encode_alias_sharded",
                   (ranks, te1, te2, ar1, ar2, count, tls), static)
