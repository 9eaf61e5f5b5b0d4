"""mic_tpu_torch — PyTorch/CUDA port of ``mic_tpu``'s device tier.

Encodes and decodes batches of MICW containers on an NVIDIA GPU through
kernels written by hand in CUDA C++ (``csrc/``, built with nvcc on first
use), byte- and bit-exact against ``mic_tpu``, which stays the
reference.  The encode (``micw_compress_device_many``) writes every
container ``mic_tpu.tpu.strips.micw_compress`` writes.  The decode
(``MicwDecodePlan`` / ``micw_decode_many`` / ``micw_decompress_device``)
takes every strip mode at any width on both entropy families (FF 57
standard at tableLog up to 16, FF 41 alias); strips with lanes != 128
and FF 41 strips above tableLog 12 take the scan tier, an L-lane rANS
kernel (``tpu.scan_decode``) with the zzd / vdd / pdd inverse fused, or
then the post stage, as do all strips of
``micw_decompress_scan`` / ``micw_decode_batch``.  ``micw_compress`` is
the host encoder at any lane count, and ``tpu.decode.mict_decode_device``
decodes one MICT stream.

The reference formats decode with their entropy stage on the GPU too:
``fse_decompress_device_batch`` decodes FF 02/04/84/08 streams through a
hand-written tANS kernel (1-state streams and streams past its caps on
the host), and the ``decompress_*_device`` functions of
``tpu.ref_decode`` serve MIC1 frames, PICS containers, MIC2 series and
MIC3 pyramids through it; ``tpu.ingest`` (``transcode_frame``,
``transcode_pics``, ``transcode_auto``, ``ingest_plan``) transcodes them
to MICW, byte-identical to ``mic_tpu.tpu.ingest``.

The device RGB, WSI and series containers ride the same kernels: MWR3
(``micwr_compress`` / ``micwr_compress_device_many`` / ``micwr_decode_many``,
the YCoCg-R transform on the GPU through ``tpu.kernels``), W3D1
(``w3d_compress`` / ``w3d_decompress_level`` / ``w3d_decompress_region``)
and the device-format MIC2 (``compress_multi_frame_device`` /
``decompress_multi_frame_device``).  ``tpu.kernels`` also holds the 5/3
lifting wavelet (``wavelet_forward_2d_separated`` and its inverse).
``python -m mic_tpu_torch.cli`` drives the MICW and MWR3 paths.

Every entry point takes an explicit ``torch.device``.  On the CPU the
kernels' plain PyTorch versions run instead, which is how the tests hold
the port against ``mic_tpu``.  The package imports nothing of
``mic_tpu`` and never imports jax: the host-side format code it shares
with ``mic_tpu`` is copied into ``mic_tpu_torch.ops`` and
``mic_tpu_torch.tpu``, each copy pinned to its original by a test.
"""

from .parallel.multiframe import compress_multi_frame_device, decompress_multi_frame_device
from .tpu.ingest import ingest_plan, transcode_auto, transcode_frame, transcode_pics
from .tpu.kernels import wavelet_forward_2d_separated, wavelet_inverse_2d_separated
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
from .tpu.rgb_device import (
    micwr_compress,
    micwr_compress_device,
    micwr_compress_device_many,
    micwr_decode_many,
    micwr_decompress_device,
)
from .tpu.strips import (
    MicwDecodePlan,
    micw_compress,
    micw_decode_batch,
    micw_decode_many,
    micw_decompress_device,
    micw_decompress_scan,
    micw_parse,
)
from .tpu.tans_decode import fse_decompress_device_batch
from .tpu.wsi_device import w3d_compress, w3d_decompress_level, w3d_decompress_region, w3d_header

__all__ = [
    "MicwDecodePlan",
    "compress_multi_frame_device",
    "decompress_frames_device",
    "decompress_mic2_device",
    "decompress_mic2_frame_device",
    "decompress_multi_frame_device",
    "decompress_pics_device",
    "decompress_pics_device_many",
    "decompress_wsi_level_device",
    "decompress_wsi_region_device",
    "decompress_wsi_tile_device",
    "fse_decompress_device_batch",
    "ingest_plan",
    "micw_compress",
    "micw_compress_device",
    "micw_compress_device_many",
    "micw_decode_batch",
    "micw_decode_many",
    "micw_decompress_device",
    "micw_decompress_scan",
    "micw_parse",
    "micwr_compress",
    "micwr_compress_device",
    "micwr_compress_device_many",
    "micwr_decode_many",
    "micwr_decompress_device",
    "transcode_auto",
    "transcode_frame",
    "transcode_pics",
    "w3d_compress",
    "w3d_decompress_level",
    "w3d_decompress_region",
    "w3d_header",
    "wavelet_forward_2d_separated",
    "wavelet_inverse_2d_separated",
]
