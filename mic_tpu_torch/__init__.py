"""mic_tpu_torch — PyTorch/CUDA port of ``mic_tpu``'s device tier.

Encodes and decodes batches of MICW containers on an NVIDIA GPU through
kernels written by hand in CUDA C++ (``csrc/``, built with nvcc on first
use), byte- and bit-exact against ``mic_tpu``, which stays the
reference.  The encode (``micw_compress_device_many``) writes every
container ``mic_tpu.tpu.strips.micw_compress`` writes.  The decode
covers the direct modes (zzd, vdd, pdd) on both entropy families (FF 57
standard, FF 41 alias); other strip modes raise ``NotImplementedError``.

Every entry point takes an explicit ``torch.device``.  On the CPU the
kernels' plain PyTorch versions run instead, which is how the tests hold
the port against ``mic_tpu``.  The package never imports jax: the host
code it shares with ``mic_tpu`` comes from the jax-free ``mic_tpu.ops``
and ``mic_tpu.native`` only.
"""

from .tpu.rans_encode import micw_compress_device, micw_compress_device_many
from .tpu.strips import MicwDecodePlan, micw_decode_many, micw_parse

__all__ = [
    "MicwDecodePlan",
    "micw_compress_device",
    "micw_compress_device_many",
    "micw_decode_many",
    "micw_parse",
]
