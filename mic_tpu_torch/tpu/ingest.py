"""Reference-format ingest: MIC1 frames and PICS containers -> MICW.

Counterpart of ``mic_tpu.tpu.ingest``, with the same entry points and an
added ``device``.  A reference blob decodes to pixels, the pixels are
re-encoded as MICW, and the containers are staged for repeated device
decode (``MicwDecodePlan``): an archive migration, or a training data
path that ingests each image once and decodes it many times.

* ``entropy="device"`` decodes the reference blob's entropy stage with
  the tANS kernel (``ref_decode.py``), for the avg and grad pipelines
  (kind 0 and 1);
* ``entropy="native"`` is the Python tier, ``models/single_frame.py`` and
  ``parallel/strips.decompress_parallel_strips``: what ``mic_tpu`` runs
  when its C++ tier (``libmicfse``) is not built.  Unlike that tier,
  which decodes every frame as avg, it honours ``kind`` 1 (grad), as the
  C++ tier does.

Kinds 2 and 3 (med, zz) decode only in ``mic_tpu``'s C++ tier, which the
port does not copy: they raise ``NotImplementedError``.  The re-encode is
the port's ``micw_compress_device`` on ``device``: with
``device_encode=True`` the zzd predictor, standard entropy (what
``mic_tpu``'s ``pallas_enc.micw_compress_device`` writes), otherwise the
trial set ``auto-fast`` with ``target_entropy`` (what ``mic_tpu``'s host
``micw_compress`` writes); both byte-identical to ``mic_tpu``
(``tests/test_torch_ingest.py``).
"""

from __future__ import annotations

import time

import numpy as np

from ..models.single_frame import decompress_single_frame, decompress_single_frame_grad
from ..parallel.strips import PICS_MAGIC, decompress_parallel_strips
from .rans_encode import micw_compress_device, micw_compress_device_many
from .strips import MicwDecodePlan

__all__ = [
    "transcode_frame",
    "transcode_pics",
    "transcode_auto",
    "ingest_plan",
]

_HOST_FRAME = {0: decompress_single_frame, 1: decompress_single_frame_grad}


def _decode_reference(blob: bytes, width: int, height: int, kind: int, device,
                      entropy: str = "native"):
    """Decode a reference-format blob to (pixels, width, height)."""
    if kind not in (0, 1):
        raise NotImplementedError(
            f"reference decode of predictor kind {kind} (med / zz) needs mic_tpu's C++ tier")
    if entropy == "device":
        from .ref_decode import decompress_frames_device, decompress_pics_device

        kname = "avg" if kind == 0 else "grad"
        if blob[:4] == PICS_MAGIC:
            return decompress_pics_device(blob, device, kind=kname)
        (px,) = decompress_frames_device([blob], [(width, height)], device, kind=kname)
        return px, width, height
    if entropy != "native":
        raise ValueError(f"ingest: unknown entropy tier {entropy!r}")
    if blob[:4] == PICS_MAGIC:
        px, w, h = decompress_parallel_strips(blob)
        return np.asarray(px), w, h
    return np.asarray(_HOST_FRAME[kind](blob, width, height)), width, height


def transcode_frame(
    blob: bytes, width: int, height: int, device, kind: int = 0,
    device_encode: bool = False, entropy: str = "native",
    target_entropy: str = "standard",
) -> bytes:
    """Reference single-frame blob (or PICS container) -> MICW.  ``kind``
    is the predictor the frame was encoded with (0 = avg, 1 = grad);
    ``entropy`` selects the reference decode ("native" or "device");
    ``target_entropy`` the MICW strip stream family ("standard" FF 57,
    "alias" FF 41 or "best"; ignored with ``device_encode``)."""
    px, w, h = _decode_reference(blob, width, height, kind, device, entropy=entropy)
    px = np.asarray(px, dtype=np.uint16)
    if device_encode:
        return micw_compress_device(px, w, h, int(px.max()), device)
    return micw_compress_device(px, w, h, int(px.max()), device, entropy=target_entropy,
                                predictor="auto-fast")


def transcode_pics(blob: bytes, device, device_encode: bool = False,
                   entropy: str = "native", target_entropy: str = "standard") -> bytes:
    """Reference PICS container -> MICW."""
    if blob[:4] != PICS_MAGIC:
        raise ValueError("not a PICS container")
    return transcode_frame(blob, 0, 0, device, 0, device_encode=device_encode,
                           entropy=entropy, target_entropy=target_entropy)


def transcode_auto(
    blob: bytes, width: int, height: int, device, kind: int = 0,
    device_encode: bool = False, entropy: str = "native",
    target_entropy: str = "standard",
) -> bytes:
    """Magic-sniffing transcode: PICS containers describe themselves (pass
    0, 0); bare frame blobs need (width, height)."""
    if blob[:4] == PICS_MAGIC:
        return transcode_pics(blob, device, device_encode=device_encode,
                              entropy=entropy, target_entropy=target_entropy)
    return transcode_frame(blob, width, height, device, kind,
                           device_encode=device_encode, entropy=entropy,
                           target_entropy=target_entropy)


def ingest_plan(ref_blobs, dims, device, kind: int = 0,
                device_encode: bool = False, entropy: str = "native",
                target_entropy: str = "standard", timings: dict | None = None):
    """Transcode a batch of reference blobs and stage them for repeated
    decode on ``device``.  ``dims`` supplies (width, height) per bare
    frame blob (ignored for PICS; None when every blob is PICS).
    Returns a :class:`MicwDecodePlan`.

    ``timings``, when a dict, receives the wall-clock split: ``decode_s``
    (reference decode; with host encode, decode and encode together),
    ``encode_s`` (MICW re-encode: one call for the whole batch with
    ``device_encode``, else 0.0) and ``stage_s`` (decode-plan staging).
    """
    t0 = time.perf_counter()
    if device_encode:
        images = []
        for i, blob in enumerate(ref_blobs):
            w, h = (0, 0) if blob[:4] == PICS_MAGIC else dims[i]
            px, w, h = _decode_reference(blob, w, h, kind, device, entropy=entropy)
            px = np.asarray(px, dtype=np.uint16)
            images.append((px, w, h, int(px.max())))
        t1 = time.perf_counter()
        micw_blobs = micw_compress_device_many(images, device)
        t2 = time.perf_counter()
    else:
        micw_blobs = [
            transcode_auto(blob, *((0, 0) if blob[:4] == PICS_MAGIC else dims[i]), device,
                           kind=kind, entropy=entropy, target_entropy=target_entropy)
            for i, blob in enumerate(ref_blobs)]
        t1 = t2 = time.perf_counter()
    plan = MicwDecodePlan(micw_blobs, device)
    if timings is not None:
        timings.update(decode_s=t1 - t0, encode_s=t2 - t1, stage_s=time.perf_counter() - t2)
    return plan
