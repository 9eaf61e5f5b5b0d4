"""mic_tpu_torch — PyTorch/CUDA port of ``mic_tpu``.

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

The reference formats are written on the host, as ``mic_tpu`` writes
them, byte for byte: MIC1 (``compress_single_frame`` at 2 / 4 / 8
states, ``_rans8``, ``_grad``, wrapped by ``write_mic1``; the
Delta+RLE+canonical-Huffman payload ``compress_single_frame_huffman``
over ``can_huffman_compress``), PICS
(``compress_parallel_strips{,_4state,_8state}``), PICA
(``compress_parallel_strips_adaptive``), MIC2 (``compress_multi_frame``,
independent or temporal), MIC3 (``compress_wsi``) and MICR
(``compress_rgb`` wrapped by ``write_micr``), with the host readers of
each (``decompress_single_frame``, ``decompress_parallel_strips``,
``decompress_parallel_strips_adaptive``, ``decompress_multi_frame``,
``decompress_frame``, ``decompress_wsi_tile`` / ``_region``,
``decompress_rgb``, ``decompress_single_frame_huffman``) and
``read_dicom`` for DICOM part-10 files; the
stages under them (RLE, the predictors, the fused Delta+RLE, the FSE /
tANS and rANS coders) are exported under ``mic_tpu``'s names and its
reference-name aliases (``FSECompressU16``, ...).  They decode with the
entropy stage on the GPU too: ``fse_decompress_device_batch`` decodes
FF 02/04/84/08 streams through a hand-written tANS kernel (1-state
streams and streams past its caps on the host), and the
``decompress_*_device`` functions of ``tpu.ref_decode`` serve MIC1
frames, PICS containers, MIC2 series and MIC3 pyramids through it (PICS
through ``PicsDecodePlan``, which keeps its answer on the GPU, as
``MicwDecodePlan`` does);
``tpu.ingest`` (``transcode_frame``, ``transcode_pics``,
``transcode_auto``, ``ingest_plan``) transcodes them to MICW,
byte-identical to ``mic_tpu.tpu.ingest``.

The device RGB, WSI and series containers ride the same kernels: MWR3
(``micwr_compress`` / ``micwr_compress_device_many`` / ``micwr_decode_many``,
the YCoCg-R transform on the GPU through ``tpu.kernels``), W3D1
(``w3d_compress`` / ``w3d_decompress_level`` / ``w3d_decompress_region``)
and the device-format MIC2 (``compress_multi_frame_device`` /
``decompress_multi_frame_device``).  ``tpu.kernels`` also holds the 5/3
lifting wavelet (``wavelet_forward_2d_separated`` and its inverse).
``tpu.strips.micw_decompress_host`` and
``tpu.rgb_device.micwr_decompress_host`` decode MICW and MWR3 in numpy,
the device decode's independent cross-check.  The host pipelines of
``mic_tpu`` are copied too: the wavelet codecs V1 / V1.5 / V2
(``models.wavelet_pipeline`` over ``ops.wavelet``), gap removal
(``ops.gapremoval``), and the comparators ``utils.charls`` (JPEG-LS) and
``utils.j2k`` (JPEG 2000), which run where their library is present.
``python -m mic_tpu_torch.cli`` drives the host formats, the wavelet and
gap-removal pipelines and the MICW and MWR3 paths.

The tiers, as in ``mic_tpu``:

* ``mic_tpu_torch.tpu`` — the device tier (CUDA kernels, above);
* ``mic_tpu_torch.native`` — the C++ host tier (ctypes over
  ``native/micfse.cpp``, a copy of ``mic_tpu``'s, built by the host
  compiler into ``build/`` at the first call, never at import; a failed
  build raises, nothing falls back).  It decodes MIC1 frames
  (``decode_frame``, ``ingest``'s default ``entropy="native"``) and PICS
  containers on a thread pool, writes the 2-, 4- and 8-state PICS
  containers, and carries MICT's host staging (the ncount header read
  and written, the L-lane rANS encode);
* ``mic_tpu_torch.ops`` / ``.models`` / ``.parallel`` — the numpy tier,
  which defines the bytes.

Every device entry point takes an explicit ``torch.device``.  On the CPU
the kernels' plain PyTorch versions run instead, which is how the tests
hold the port against ``mic_tpu``.  The package imports nothing of
``mic_tpu`` and never imports jax: the host-side format code it shares
with ``mic_tpu`` is copied into ``mic_tpu_torch.ops``, ``.models``,
``.parallel``, ``.utils`` and ``.tpu``, each copy pinned to its original
by a test.
"""

from .models.rgb import compress_rgb, decompress_rgb
from .models.single_frame import (
    compress_residual_frame,
    compress_single_frame,
    compress_single_frame_4state,
    compress_single_frame_8state,
    compress_single_frame_grad,
    compress_single_frame_huffman,
    compress_single_frame_rans8,
    decode_frame,
    decompress_residual_frame,
    decompress_single_frame,
    decompress_single_frame_grad,
    decompress_single_frame_huffman,
)
from .ops.deltarle import (
    delta_rle_compress,
    delta_rle_decompress,
    grad_delta_rle_compress,
    grad_delta_rle_decompress,
    zz_delta_rle_compress,
    zz_delta_rle_decompress,
)
from .ops.fse import IncompressibleError, UseRLEError
from .ops.fse_codec import (
    ScratchU16,
    fse_compress,
    fse_compress_2state,
    fse_compress_4state,
    fse_compress_8state,
    fse_decompress,
    fse_decompress_2state,
    fse_decompress_4state,
    fse_decompress_8state,
    fse_decompress_auto,
)
from .ops.huffman import can_huffman_compress, can_huffman_decompress
from .ops.predictors import (
    delta_compress,
    delta_decompress,
    delta_zz_compress,
    delta_zz_decompress,
    grad_delta_compress,
    grad_delta_decompress,
    med_delta_compress,
    med_delta_decompress,
    temporal_delta_decode,
    temporal_delta_encode,
    unzigzag,
    zigzag,
)
from .ops.rans import rans_compress_8state, rans_decompress_8state
from .ops.rle import rle_compress, rle_decompress
from .parallel.multiframe import (
    compress_multi_frame,
    compress_multi_frame_device,
    decompress_frame,
    decompress_multi_frame,
    decompress_multi_frame_device,
)
from .parallel.strips import (
    compress_parallel_strips,
    compress_parallel_strips_4state,
    compress_parallel_strips_8state,
    decompress_parallel_strips,
)
from .parallel.strips_adaptive import (
    compress_parallel_strips_adaptive,
    decompress_parallel_strips_adaptive,
)
from .parallel.wsi import (
    WSIOptions,
    compress_wsi,
    decompress_wsi_region,
    decompress_wsi_tile,
    read_wsi_header,
)
from .tpu.ingest import ingest_plan, transcode_auto, transcode_frame, transcode_pics
from .tpu.kernels import wavelet_forward_2d_separated, wavelet_inverse_2d_separated
from .tpu.rans_encode import micw_compress_device, micw_compress_device_many
from .tpu.ref_decode import (
    PicsDecodePlan,
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
from .utils.dicom import DicomImage, read_dicom
from .utils.io import read_mic1, read_micr, write_mic1, write_micr

# Reference-name aliases (Go API surface), as mic_tpu defines them.
FSECompressU16 = fse_compress
FSEDecompressU16 = fse_decompress
FSECompressU16TwoState = fse_compress_2state
FSEDecompressU16TwoState = fse_decompress_2state
FSECompressU16FourState = fse_compress_4state
FSEDecompressU16FourState = fse_decompress_4state
FSECompressU16EightState = fse_compress_8state
FSEDecompressU16EightState = fse_decompress_8state
FSEDecompressU16Auto = fse_decompress_auto
RANSCompressU16EightState = rans_compress_8state
RANSDecompressU16EightState = rans_decompress_8state
CompressSingleFrame = compress_single_frame
CompressSingleFrame4State = compress_single_frame_4state
CompressSingleFrame8State = compress_single_frame_8state
CompressSingleFrameGrad = compress_single_frame_grad
DecompressSingleFrame = decompress_single_frame
DecompressSingleFrameGrad = decompress_single_frame_grad
TemporalDeltaEncode = temporal_delta_encode
TemporalDeltaDecode = temporal_delta_decode
ZigZag = zigzag
UnZigZag = unzigzag
CanHuffmanCompressU16 = can_huffman_compress
CanHuffmanDecompressU16 = can_huffman_decompress

__all__ = [
    "can_huffman_compress",
    "can_huffman_decompress",
    "CanHuffmanCompressU16",
    "CanHuffmanDecompressU16",
    "compress_multi_frame",
    "compress_multi_frame_device",
    "compress_parallel_strips",
    "compress_parallel_strips_4state",
    "compress_parallel_strips_8state",
    "compress_parallel_strips_adaptive",
    "compress_residual_frame",
    "compress_rgb",
    "compress_single_frame",
    "compress_single_frame_4state",
    "compress_single_frame_8state",
    "compress_single_frame_grad",
    "compress_single_frame_huffman",
    "compress_single_frame_rans8",
    "compress_wsi",
    "CompressSingleFrame",
    "CompressSingleFrame4State",
    "CompressSingleFrame8State",
    "CompressSingleFrameGrad",
    "decode_frame",
    "decompress_frame",
    "decompress_frames_device",
    "decompress_mic2_device",
    "decompress_mic2_frame_device",
    "decompress_multi_frame",
    "decompress_multi_frame_device",
    "decompress_parallel_strips",
    "decompress_parallel_strips_adaptive",
    "decompress_pics_device",
    "decompress_pics_device_many",
    "decompress_residual_frame",
    "decompress_rgb",
    "decompress_single_frame",
    "decompress_single_frame_grad",
    "decompress_single_frame_huffman",
    "decompress_wsi_level_device",
    "decompress_wsi_region",
    "decompress_wsi_region_device",
    "decompress_wsi_tile",
    "decompress_wsi_tile_device",
    "DecompressSingleFrame",
    "DecompressSingleFrameGrad",
    "delta_compress",
    "delta_decompress",
    "delta_rle_compress",
    "delta_rle_decompress",
    "delta_zz_compress",
    "delta_zz_decompress",
    "DicomImage",
    "fse_compress",
    "fse_compress_2state",
    "fse_compress_4state",
    "fse_compress_8state",
    "fse_decompress",
    "fse_decompress_2state",
    "fse_decompress_4state",
    "fse_decompress_8state",
    "fse_decompress_auto",
    "fse_decompress_device_batch",
    "FSECompressU16",
    "FSECompressU16EightState",
    "FSECompressU16FourState",
    "FSECompressU16TwoState",
    "FSEDecompressU16",
    "FSEDecompressU16Auto",
    "FSEDecompressU16EightState",
    "FSEDecompressU16FourState",
    "FSEDecompressU16TwoState",
    "grad_delta_compress",
    "grad_delta_decompress",
    "grad_delta_rle_compress",
    "grad_delta_rle_decompress",
    "IncompressibleError",
    "ingest_plan",
    "med_delta_compress",
    "med_delta_decompress",
    "micw_compress",
    "micw_compress_device",
    "micw_compress_device_many",
    "micw_decode_batch",
    "micw_decode_many",
    "micw_decompress_device",
    "micw_decompress_scan",
    "micw_parse",
    "MicwDecodePlan",
    "PicsDecodePlan",
    "micwr_compress",
    "micwr_compress_device",
    "micwr_compress_device_many",
    "micwr_decode_many",
    "micwr_decompress_device",
    "rans_compress_8state",
    "rans_decompress_8state",
    "RANSCompressU16EightState",
    "RANSDecompressU16EightState",
    "read_dicom",
    "read_mic1",
    "read_micr",
    "read_wsi_header",
    "rle_compress",
    "rle_decompress",
    "ScratchU16",
    "temporal_delta_decode",
    "temporal_delta_encode",
    "TemporalDeltaDecode",
    "TemporalDeltaEncode",
    "transcode_auto",
    "transcode_frame",
    "transcode_pics",
    "UnZigZag",
    "unzigzag",
    "UseRLEError",
    "w3d_compress",
    "w3d_decompress_level",
    "w3d_decompress_region",
    "w3d_header",
    "wavelet_forward_2d_separated",
    "wavelet_inverse_2d_separated",
    "write_mic1",
    "write_micr",
    "WSIOptions",
    "ZigZag",
    "zigzag",
    "zz_delta_rle_compress",
    "zz_delta_rle_decompress",
]
