"""mic_tpu_torch — PyTorch/CUDA port of ``mic_tpu``'s device tier.

Encodes and decodes batches of MICW containers on an NVIDIA GPU through
kernels written by hand in CUDA C++ (``csrc/``, built with nvcc on first
use), byte- and bit-exact against ``mic_tpu``, which stays the
reference.  The encode (``micw_compress_device_many``) writes every
container ``mic_tpu.tpu.strips.micw_compress`` writes.  The decode
(``MicwDecodePlan`` / ``micw_decode_many`` / ``micw_decompress_device``)
takes every strip mode at any width on both entropy families (FF 57
standard at tableLog up to 16, FF 41 alias); strips with lanes != 128
and FF 41 strips above tableLog 12 raise ``NotImplementedError``.

The reference formats decode with their entropy stage on the GPU too:
``fse_decompress_device_batch`` decodes FF 02/04/84/08 streams through a
hand-written tANS kernel (1-state streams and streams past its caps on
the host), and the ``decompress_*_device`` functions of
``tpu.ref_decode`` serve MIC1 frames, PICS containers, MIC2 series and
MIC3 pyramids through it; ``tpu.ingest`` (``transcode_frame``,
``transcode_pics``, ``transcode_auto``, ``ingest_plan``) transcodes them
to MICW, byte-identical to ``mic_tpu.tpu.ingest``.

Every entry point takes an explicit ``torch.device``.  On the CPU the
kernels' plain PyTorch versions run instead, which is how the tests hold
the port against ``mic_tpu``.  The package imports nothing of
``mic_tpu`` and never imports jax: the host-side format code it shares
with ``mic_tpu`` is copied into ``mic_tpu_torch.ops`` and
``mic_tpu_torch.tpu``, each copy pinned to its original by a test.
"""

from .tpu.ingest import ingest_plan, transcode_auto, transcode_frame, transcode_pics
from .tpu.rans_encode import micw_compress_device, micw_compress_device_many
from .tpu.ref_decode import (
    decompress_frames_device,
    decompress_mic2_device,
    decompress_mic2_frame_device,
    decompress_pics_device,
    decompress_pics_device_many,
    decompress_wsi_level_device,
    decompress_wsi_region_device,
    decompress_wsi_tile_device,
)
from .tpu.strips import MicwDecodePlan, micw_decode_many, micw_decompress_device, micw_parse
from .tpu.tans_decode import fse_decompress_device_batch

__all__ = [
    "MicwDecodePlan",
    "decompress_frames_device",
    "decompress_mic2_device",
    "decompress_mic2_frame_device",
    "decompress_pics_device",
    "decompress_pics_device_many",
    "decompress_wsi_level_device",
    "decompress_wsi_region_device",
    "decompress_wsi_tile_device",
    "fse_decompress_device_batch",
    "ingest_plan",
    "micw_compress_device",
    "micw_compress_device_many",
    "micw_decode_many",
    "micw_decompress_device",
    "micw_parse",
    "transcode_auto",
    "transcode_frame",
    "transcode_pics",
]
