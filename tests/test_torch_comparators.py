"""The port's comparators, ``utils.charls`` (JPEG-LS through
``libcharls``) and ``utils.j2k`` (JPEG 2000 through Pillow), against
``mic_tpu.utils``'s: the same bytes and the same pixels where the
library is present (each test skips where it is absent, as
``tests/test_charls.py`` / ``test_j2k.py`` do), and the clean refusal
of every entry point where it is not.
"""

from pathlib import Path

import numpy as np
import pytest

from mic_tpu.utils import charls as ref_charls
from mic_tpu.utils import j2k as ref_j2k
from mic_tpu_torch.utils import charls, j2k

TESTDATA = Path(__file__).resolve().parent.parent / "web" / "testdata"


def _images(rng):
    ct = np.fromfile(TESTDATA / "CT_2s.raw", "<u2").reshape(512, 512)
    rgb = (rng.integers(0, 255, (40, 56, 3), dtype=np.uint16) // 3 * 3).astype(np.uint8)
    return ct, rgb


@pytest.fixture()
def charls_lib():
    if not charls.available():
        pytest.skip("libcharls not present")


@pytest.fixture()
def j2k_codec():
    if not j2k.available():
        pytest.skip("Pillow JPEG2000 codec not present")


def test_availability_matches_reference():
    assert charls.available() == ref_charls.available()
    assert j2k.available() == ref_j2k.available()


def test_charls_matches_reference(charls_lib, rng):
    ct, rgb = _images(rng)
    bps = max(int(ct.max()).bit_length(), 2)
    for img, kw in ((ct, {"bits_per_sample": bps}), (rgb, {}),
                    (ct[:64, :80] & 0xFF, {"bits_per_sample": 8})):
        blob = charls.encode(img, **kw)
        assert blob == ref_charls.encode(img, **kw)
        out = charls.decode(blob)
        ref_out = ref_charls.decode(blob)
        assert out.dtype == ref_out.dtype and np.array_equal(out, ref_out)
        assert np.array_equal(out, img)
    with pytest.raises(ValueError, match="unsupported shape"):
        charls.encode(np.zeros((4, 4, 2), np.uint8))


def test_j2k_matches_reference(j2k_codec, rng):
    ct, rgb = _images(rng)
    for img in (ct, rgb):
        blob = j2k.encode(img)
        assert blob == ref_j2k.encode(img)
        out = j2k.decode(blob)
        ref_out = ref_j2k.decode(blob)
        assert out.dtype == ref_out.dtype and np.array_equal(out, ref_out)
        assert np.array_equal(out, img)
    with pytest.raises(ValueError, match="unsupported image"):
        j2k.encode(np.zeros((4, 4), np.int32))


def test_absent_libraries_refuse_cleanly(monkeypatch):
    """Without the library, ``available()`` is False and every entry
    point raises RuntimeError, as ``mic_tpu``'s do."""
    monkeypatch.setattr(charls, "_lib", lambda: None)
    monkeypatch.setattr(j2k, "available", lambda: False)
    assert not charls.available()
    img = np.zeros((8, 8), np.uint16)
    for fn, arg in ((charls.encode, img), (charls.decode, b"\xff\xd8"), (j2k.encode, img),
                    (j2k.decode, b"\xff\x4f")):
        with pytest.raises(RuntimeError, match="not available"):
            fn(arg)
