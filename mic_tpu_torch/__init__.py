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

Every entry point takes an explicit ``torch.device``.  On the CPU the
kernels' plain PyTorch versions run instead, which is how the tests hold
the port against ``mic_tpu``.  The package imports nothing of
``mic_tpu`` and never imports jax: the host-side format code it shares
with ``mic_tpu`` is copied into ``mic_tpu_torch.ops`` and
``mic_tpu_torch.tpu``, each copy pinned to its original by a test.
"""

from .tpu.rans_encode import micw_compress_device, micw_compress_device_many
from .tpu.strips import MicwDecodePlan, micw_decode_many, micw_decompress_device, micw_parse

__all__ = [
    "MicwDecodePlan",
    "micw_compress_device",
    "micw_compress_device_many",
    "micw_decode_many",
    "micw_decompress_device",
    "micw_parse",
]
