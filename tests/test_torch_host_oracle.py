"""The port's host MICW / MWR3 decoders (``micw_decompress_host``,
``micwr_decompress_host``) and the SoA-RLE helpers under them
(``rle_to_soa``, ``soa_expand``) against ``mic_tpu``'s.

* ``rle_to_soa`` / ``soa_expand`` on seeded streams, array for array;
* ``micw_decompress_host`` on every ``.micw`` of ``web/testdata`` and
  ``tests/data/torch_port``: equal to ``mic_tpu.tpu.strips
  .micw_decompress_host``, to the ``.raw`` fixture and to the port's
  ``MicwDecodePlan`` on the CPU; ``micwr_decompress_host`` on
  ``tissue_dev.mwr3`` likewise;
* damaged containers (a banded extension or a strip cut short, forged
  token counts) raise where ``mic_tpu`` raises, with its message;
* Huffman's ``limit``, as ``tests/test_corruption_hardening.py`` holds
  ``mic_tpu``'s.

Tolerance 0: a lossless codec.
"""

import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from mic_tpu.ops import huffman as ref_huffman
from mic_tpu.ops import rle as ref_rle
from mic_tpu.tpu import rgb_device as ref_rgb
from mic_tpu.tpu import strips as ref_st
from mic_tpu_torch.ops import huffman, rle
from mic_tpu_torch.tpu import rgb_device, strips

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "web" / "testdata"
PORT_DATA = ROOT / "tests" / "data" / "torch_port"
CPU = torch.device("cpu")
CONTAINERS = sorted(TESTDATA.glob("*.micw")) + sorted(PORT_DATA.glob("*.micw"))


def _expected(path: Path) -> np.ndarray:
    """The pixels a fixture holds: its ``.raw`` beside it, CT_dev's for the
    CT re-encodes, a channel of ``tissue_dev.raw`` for the tissue planes."""
    raw = path.with_suffix(".raw")
    if raw.exists():
        return np.fromfile(raw, "<u2")
    if path.name.startswith("CT_dev"):
        return np.fromfile(TESTDATA / "CT_dev.raw", "<u2")
    rgb = np.fromfile(TESTDATA / "tissue_dev.raw", np.uint8).reshape(-1, 3)
    return rgb[:, "rgb".index(path.name[len("tissue_")])].astype(np.uint16)


def _streams():
    """Seeded interleaved RLE streams at the midCounts the formats use."""
    rng = np.random.default_rng(21)
    for mid in (127, 1023, 16383):
        data = np.repeat(rng.integers(0, 900, 300), rng.integers(1, 40, 300)).astype(np.uint16)
        yield mid, ref_rle.rle_compress(data, len(data), 1, 2 * mid + 1)
        yield mid, ref_rle.rle_compress(rng.integers(0, 50, 2000).astype(np.uint16), 2000, 1,
                                        2 * mid + 1)
    yield 511, np.zeros(0, np.uint16)


def test_rle_to_soa_and_soa_expand_match():
    for mid, stream in _streams():
        start = 1 if len(stream) else 0
        got, want = rle.rle_to_soa(stream, start, mid), ref_rle.rle_to_soa(stream, start, mid)
        assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        back = rle.soa_expand(*got, mid)
        assert back.dtype == np.uint16
        assert np.array_equal(back, ref_rle.soa_expand(*want, mid))
        assert np.array_equal(back, rle.rle_expand(stream, start, mid)[0])
    rng = np.random.default_rng(22)
    tokens = np.repeat(rng.integers(0, 60, 500), rng.integers(1, 60, 500)).astype(np.uint16)
    for mid, min_same in ((16383, 16), (1023, 3)):
        soa = rle.soa_encode(tokens, mid, min_same=min_same)
        assert np.array_equal(rle.soa_expand(*soa, mid), ref_rle.soa_expand(*soa, mid))
        assert np.array_equal(rle.soa_expand(*soa, mid), tokens)


@pytest.fixture(scope="module")
def plan_outputs():
    """Every container through one ``MicwDecodePlan`` on the CPU."""
    blobs = [p.read_bytes() for p in CONTAINERS]
    return dict(zip(CONTAINERS, strips.micw_decode_many(blobs, CPU)))


@pytest.mark.parametrize("path", CONTAINERS, ids=lambda p: p.name)
def test_micw_host_oracle_matches(path, plan_outputs):
    blob = path.read_bytes()
    px, w, h = strips.micw_decompress_host(blob)
    ref_px, ref_w, ref_h = ref_st.micw_decompress_host(blob)
    assert (w, h) == (ref_w, ref_h) and px.dtype == ref_px.dtype == np.uint16
    assert np.array_equal(px, ref_px)
    assert np.array_equal(px, _expected(path))
    dev_px, dev_w, dev_h = plan_outputs[path]
    assert (dev_w, dev_h) == (w, h) and np.array_equal(np.asarray(dev_px), px)


def test_micwr_host_oracle_matches():
    blob = (TESTDATA / "tissue_dev.mwr3").read_bytes()
    rgb, w, h = rgb_device.micwr_decompress_host(blob)
    ref, ref_w, ref_h = ref_rgb.micwr_decompress_host(blob)
    assert (w, h) == (ref_w, ref_h) == (512, 384)
    assert rgb.dtype == ref.dtype == np.uint8 and np.array_equal(rgb, ref)
    assert np.array_equal(rgb, np.fromfile(TESTDATA / "tissue_dev.raw", np.uint8))
    ((dev, dev_w, dev_h),) = rgb_device.micwr_decode_many([blob], CPU)
    assert (dev_w, dev_h) == (w, h) and np.array_equal(np.asarray(dev), rgb)


def test_micwr_host_oracle_crops_padded_planes():
    """An image whose width is no multiple of 128: each plane is stored
    edge-padded and the host decoder crops it, as ``mic_tpu``'s does."""
    rgb = np.fromfile(TESTDATA / "tissue_dev.raw", np.uint8).reshape(384, 512, 3)
    crop = np.ascontiguousarray(rgb[40:90, 100:300])
    blob = ref_rgb.micwr_compress(crop.ravel(), 200, 50)
    got = rgb_device.micwr_decompress_host(blob)
    assert got[1:] == (200, 50) and np.array_equal(got[0], crop.ravel())
    assert np.array_equal(got[0], ref_rgb.micwr_decompress_host(blob)[0])


def _outcome(fn, blob):
    try:
        px, w, h = fn(blob)
        return ("ok", w, h, np.asarray(px).tobytes())
    except ValueError as e:
        return ("ValueError", str(e))


def _forge_tokens(blob: bytes, strip: int, delta: int) -> bytes:
    """``blob`` with strip ``strip``'s nTokens entry moved by ``delta``."""
    b = bytearray(blob)
    flags = b[22]
    entry = ref_st.MICW_HEADER + (8 if flags & 0x08 else 0) + strip * ref_st.MICW_ENTRY
    n_tok = struct.unpack_from("<I", b, entry + 12)[0]
    struct.pack_into("<I", b, entry + 12, n_tok + delta)
    return bytes(b)


def _damaged():
    wide = (TESTDATA / "wide_banded.micw").read_bytes()
    assert ref_st.micw_band_info(wide) is not None  # banded by construction
    ct = (TESTDATA / "CT_dev.micw").read_bytes()
    pdr = (PORT_DATA / "tissue_g_pdr.micw").read_bytes()
    zzr_alias = (PORT_DATA / "tissue_g_zzr_alias.micw").read_bytes()
    avg = (TESTDATA / "MR_dev_auto.micw").read_bytes()
    return {
        "banded extension cut": wide[:ref_st.MICW_HEADER + 3],
        "banded strip table cut": wide[:ref_st.MICW_HEADER + 8 + 5],
        "strip cut short": ct[:len(ct) - 100],
        "magic": b"MICX" + ct[4:],
        "r-mode tokens + 1": _forge_tokens(pdr, 0, 1),
        "r-mode tokens - 7": _forge_tokens(pdr, 1, -7),
        "alias r-mode tokens + 3": _forge_tokens(zzr_alias, 0, 3),
        "escaped tokens + 1": _forge_tokens(avg, 0, 1),
    }


@pytest.mark.parametrize("kind", sorted(_damaged()))
def test_damaged_containers_raise_like_reference(kind):
    blob = _damaged()[kind]
    got = _outcome(strips.micw_decompress_host, blob)
    assert got == _outcome(ref_st.micw_decompress_host, blob)
    assert got[0] == "ValueError"


def test_huffman_respects_limit():
    rng = np.random.default_rng(23)
    syms = np.minimum(rng.geometric(0.05, 20000), 400).astype(np.uint16)
    blob = huffman.can_huffman_compress(syms)
    assert blob == ref_huffman.can_huffman_compress(syms)
    # n_out is the first 32 bits, MSB-first.
    huge = int(0xFFFFFFF0).to_bytes(4, "big") + blob[4:]
    with pytest.raises(ValueError, match="DecompressLimit") as got:
        huffman.can_huffman_decompress(huge, limit=1 << 20)
    with pytest.raises(ValueError, match="DecompressLimit") as want:
        ref_huffman.can_huffman_decompress(huge, limit=1 << 20)
    assert str(got.value) == str(want.value)
    assert np.array_equal(huffman.can_huffman_decompress(blob, limit=len(syms)), syms)
