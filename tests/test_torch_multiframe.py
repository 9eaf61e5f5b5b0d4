"""The port's device-format MIC2 series
(``mic_tpu_torch.parallel.multiframe``) against
``mic_tpu.parallel.multiframe``.

Tolerance 0.  Both in-repo fixtures (``web/testdata/series_dev_ind.mic2``
and ``series_dev_tmp.mic2``: three 512x512 CT frames, independent and
temporal, every frame a MICW blob) are decoded against their ``.raw`` and
re-encoded byte for byte; a small series covers ``device_encode``, both
entropy families and ``mic_tpu``'s own device decode (Pallas, interpret
mode).  A 64-lane series (the host encoder's copy) is written byte for
byte and decodes through the scan tier.
Also pins the port's copy of ``write_mic2``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mic_tpu_torch import compress_multi_frame_device, decompress_multi_frame_device
from mic_tpu_torch.parallel import multiframe as port

CPU = torch.device("cpu")
TESTDATA = Path(__file__).resolve().parent.parent / "web" / "testdata"
SERIES = ["ind", "tmp"]


class _Reference:
    """``mic_tpu.parallel.multiframe``, imported at first use: the machine
    that runs the ``cuda`` tests has no jax."""

    def __getattr__(self, name):
        if name.startswith(("__", "_pytest", "pytest")):  # pytest's collection probes
            raise AttributeError(name)
        pytest.importorskip("jax")
        from mic_tpu.parallel import multiframe

        return getattr(multiframe, name)


ref = _Reference()


def _fixture(name):
    blob = (TESTDATA / f"series_dev_{name}.mic2").read_bytes()
    raw = np.fromfile(TESTDATA / f"series_dev_{name}.raw", "<u2").reshape(3, -1)
    return blob, raw


def _small_series():
    """Four 128x64 frames cut from the CT fixture, drifting by a row."""
    ct = np.fromfile(TESTDATA / "CT_dev.raw", "<u2").reshape(512, 512)
    return [np.ascontiguousarray(ct[200 + k : 264 + k, 192:320]).ravel() for k in range(4)]


def test_write_mic2_copy_matches():
    frames = [b"abc", b"", b"defgh"]
    for temporal in (False, True):
        got = port.write_mic2(port.MIC2Header(7, 9, 3, temporal), frames)
        assert got == ref.write_mic2(ref.MIC2Header(7, 9, 3, temporal), frames)
        hdr, entries, off = port.read_mic2_header(got)
        assert (hdr.width, hdr.height, hdr.frame_count, hdr.temporal) == (7, 9, 3, temporal)
        assert [port.extract_frame(got, entries, off, i) for i in range(3)] == frames
    with pytest.raises(ValueError):
        port.write_mic2(port.MIC2Header(7, 9, 2, False), frames)


@pytest.mark.parametrize("name", SERIES)
def test_fixture_decodes_to_raw(name):
    blob, raw = _fixture(name)
    frames, hdr = decompress_multi_frame_device(blob, CPU)
    assert (hdr.width, hdr.height, hdr.frame_count) == (512, 512, 3)
    assert hdr.temporal == (name == "tmp")
    for f, want in zip(frames, raw):
        assert f.dtype == np.uint16 and np.array_equal(f, want)
    want_frames, _hdr = ref.decompress_multi_frame(blob)  # mic_tpu's host decoder
    assert all(np.array_equal(f, w) for f, w in zip(frames, want_frames))


@pytest.mark.parametrize("name", SERIES)
def test_fixture_encode_is_byte_identical(name):
    blob, raw = _fixture(name)
    mx = int(raw[0].max())  # the fixtures were written with the first frame's maximum
    got = compress_multi_frame_device(list(raw), 512, 512, mx, CPU, temporal=name == "tmp")
    assert got == blob


@pytest.mark.parametrize("entropy", ["standard", "alias"])
@pytest.mark.parametrize("temporal", [False, True])
@pytest.mark.parametrize("device_encode", [False, True])
def test_small_series_matches_reference(device_encode, temporal, entropy):
    frames = _small_series()
    mx = int(max(f.max() for f in frames))
    got = compress_multi_frame_device(frames, 128, 64, mx, CPU, temporal=temporal,
                                      entropy=entropy, device_encode=device_encode)
    want = ref.compress_multi_frame_device(frames, 128, 64, mx, temporal=temporal,
                                           entropy=entropy, device_encode=device_encode)
    assert got == want
    out, hdr = decompress_multi_frame_device(got, CPU)
    assert hdr.temporal == temporal and len(out) == 4
    assert all(np.array_equal(o, f) for o, f in zip(out, frames))
    ref_out, _hdr = ref.decompress_multi_frame_device(got)
    assert all(np.array_equal(np.asarray(o), f) for o, f in zip(ref_out, frames))


def test_lanes_64_raises_and_writes_nothing():
    """At 64 lanes the port writes mic_tpu's series byte for byte: the
    host encoder's copy, frame by frame (as mic_tpu does)."""
    frames = _small_series()
    got = compress_multi_frame_device(frames, 128, 64, 4095, CPU, lanes=64)
    assert got == ref.compress_multi_frame_device(frames, 128, 64, 4095, lanes=64)
    # with device_encode the reference's device encoder does not read
    # ``lanes`` either: 128-lane containers, the same bytes
    got = compress_multi_frame_device(frames, 128, 64, 4095, CPU, lanes=64, device_encode=True)
    assert got == ref.compress_multi_frame_device(frames, 128, 64, 4095, lanes=64,
                                                  device_encode=True)


def test_64_lane_container_raises_on_decode():
    """A 64-lane series decodes through the scan tier, bit-exact."""
    frames = _small_series()
    blob = ref.compress_multi_frame_device(frames, 128, 64, 4095, lanes=64)
    out, hdr = decompress_multi_frame_device(blob, CPU)
    assert hdr.frame_count == len(frames)
    assert all(np.array_equal(o, f) for o, f in zip(out, frames))


def test_truncated_series_raises():
    blob, _raw = _fixture("ind")
    for cut in (10, 30, len(blob) - 100):
        with pytest.raises(ValueError):
            decompress_multi_frame_device(blob[:cut], CPU)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERIES)
def test_cuda_fixture_round_trip(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    blob, raw = _fixture(name)
    frames, _hdr = decompress_multi_frame_device(blob, dev)
    assert all(np.array_equal(f, w) for f, w in zip(frames, raw))
    got = compress_multi_frame_device(list(raw), 512, 512, int(raw[0].max()), dev,
                                      temporal=name == "tmp")
    assert got == blob
