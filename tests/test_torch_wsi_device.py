"""The port's W3D1 container (``mic_tpu_torch.tpu.wsi_device``) against
``mic_tpu.tpu.wsi_device``.

Tolerance 0.  The repository holds no W3D1 fixture, so the container is
built by ``mic_tpu``'s ``w3d_compress`` from ``web/testdata/tissue_dev.raw``
(512x384 RGB) at 128x128 tiles: 12 tiles at level 0, 6 of them the
constant white background, and a pyramid of three levels.  Level 0 and
regions are held against the source pixels (the codec is lossless),
level 1 against ``mic_tpu.ops.pyramid``; both packages' containers are
byte-identical with and without ``device_encode``.  Also pins the port's
copy of ``downsample2x_rgb``.
"""

import importlib
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from mic_tpu_torch.ops import pyramid
from mic_tpu_torch.tpu import kernels as K
from mic_tpu_torch.tpu import wsi_device as port

CPU = torch.device("cpu")
TESTDATA = Path(__file__).resolve().parent.parent / "web" / "testdata"
W, H, TW, TH = 512, 384, 128, 128


class _Reference:
    """A module of ``mic_tpu``, imported at first use: the machine that
    runs the ``cuda`` tests has no jax."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        if name.startswith(("__", "_pytest", "pytest")):  # pytest's collection probes
            raise AttributeError(name)
        pytest.importorskip("jax")
        return getattr(importlib.import_module(self._module), name)


ref = _Reference("mic_tpu.tpu.wsi_device")
ref_pyramid = _Reference("mic_tpu.ops.pyramid")


@pytest.fixture(scope="module")
def tissue():
    return np.fromfile(TESTDATA / "tissue_dev.raw", np.uint8)


@pytest.fixture(scope="module")
def container(tissue):
    """mic_tpu's container, host encode (the "auto" trial set)."""
    return ref.w3d_compress(tissue, W, H, tile_w=TW, tile_h=TH)


def test_downsample_copy_matches(tissue):
    rng = np.random.default_rng(2)
    cases = [(tissue, W, H), (rng.integers(0, 256, 7 * 5 * 3).astype(np.uint8), 7, 5),
             (rng.integers(0, 256, 3).astype(np.uint8), 1, 1)]
    for src, w, h in cases:
        got, want = pyramid.downsample2x_rgb(src, w, h), ref_pyramid.downsample2x_rgb(src, w, h)
        assert got[1:] == want[1:]
        if want[0] is None:
            assert got[0] is None
        else:
            assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])


def test_header_and_levels_match(container):
    assert port.w3d_header(container) == ref.w3d_header(container)
    (w, h, tw, th, levels), entries, _off = port.w3d_header(container)
    assert (w, h, tw, th, levels) == (W, H, TW, TH, 3)
    assert sum(1 for e in entries if e[0] == 0) == 12
    assert sum(1 for e in entries if e[3] == port.TILE_CONST) >= 6
    for args in ((W, H, TW, TH, 0), (W, H, TW, TH, 2), (5, 3, 4, 4, 0), (1, 1, 4, 4, 3)):
        assert port._levels(*args) == ref._levels(*args)


def test_level0_equals_source(container, tissue):
    K.ycocgr_inverse.launches = 0
    rgb, w, h = port.w3d_decompress_level(container, CPU, 0)
    assert (w, h) == (W, H) and rgb.dtype == np.uint8 and np.array_equal(rgb, tissue)
    assert K.ycocgr_inverse.launches == 0  # CPU tensors: the plain twin


@pytest.mark.parametrize("level", [1, 2])
def test_upper_levels_equal_reference_pyramid(container, tissue, level):
    want, w, h = tissue, W, H
    for _ in range(level):
        want, w, h = ref_pyramid.downsample2x_rgb(want, w, h)
    rgb, gw, gh = port.w3d_decompress_level(container, CPU, level)
    assert (gw, gh) == (w, h) and np.array_equal(rgb, want)


@pytest.mark.parametrize("region", [(100, 90, 200, 150), (0, 0, 130, 10), (300, 250, 400, 400),
                                    (127, 127, 2, 2), (511, 383, 5, 5)])
def test_regions_equal_source(container, tissue, region):
    x, y, rw, rh = region
    got, gw, gh = port.w3d_decompress_region(container, x, y, rw, rh, CPU)
    want = tissue.reshape(H, W, 3)[y : y + rh, x : x + rw]
    assert (gw, gh) == (want.shape[1], want.shape[0])
    assert np.array_equal(got.reshape(gh, gw, 3), want)


def test_region_of_level1_equals_reference(container):
    got = port.w3d_decompress_region(container, 60, 40, 150, 100, CPU, level=1)
    want = ref.w3d_decompress_region(container, 60, 40, 150, 100, level=1)
    assert got[1:] == want[1:] and np.array_equal(got[0], want[0])


def test_host_trial_container_is_byte_identical(container, tissue):
    assert port.w3d_compress(tissue, W, H, CPU, tile_w=TW, tile_h=TH) == container


@pytest.mark.parametrize("num_levels", [0, 1])
def test_device_encode_container_is_byte_identical(tissue, num_levels):
    """Every non-constant tile of every level in one encode call; an
    odd-sized slide pads its edge tiles by replication."""
    img = np.ascontiguousarray(tissue.reshape(H, W, 3)[60:330, 120:400])  # 280 x 270
    h, w = img.shape[:2]
    K.ycocgr_forward.launches = 0
    got = port.w3d_compress(img.reshape(-1), w, h, CPU, tile_w=TW, tile_h=TH,
                            num_levels=num_levels, device_encode=True)
    want = ref.w3d_compress(img.reshape(-1), w, h, tile_w=TW, tile_h=TH,
                            num_levels=num_levels, device_encode=True)
    assert got == want
    assert K.ycocgr_forward.launches == 0
    rgb, gw, gh = port.w3d_decompress_level(got, CPU, 0)
    assert (gw, gh) == (w, h) and np.array_equal(rgb, img.reshape(-1))
    reg, rw, rh = port.w3d_decompress_region(got, 250, 200, 100, 100, CPU)
    assert (rw, rh) == (30, 70) and np.array_equal(reg.reshape(rh, rw, 3), img[200:, 250:])


def test_all_constant_slide():
    flat = np.full(200 * 100 * 3, 255, np.uint8)
    got = port.w3d_compress(flat, 200, 100, CPU, tile_w=TW, tile_h=TH, device_encode=True)
    assert got == ref.w3d_compress(flat, 200, 100, tile_w=TW, tile_h=TH)
    rgb, w, h = port.w3d_decompress_level(got, CPU, 1)
    assert (w, h) == (100, 50) and (rgb == 255).all()


def test_bad_input_raises(container):
    with pytest.raises(ValueError):
        port.w3d_compress(np.zeros(10, np.uint8), 4, 4, CPU)
    with pytest.raises(ValueError):
        port.w3d_header(b"W3D0" + container[4:])
    with pytest.raises(ValueError):
        port.w3d_header(container[:20])
    n = struct.unpack_from("<I", container, 24)[0]
    with pytest.raises(ValueError):
        port.w3d_decompress_level(container[: port.HDR + n * port.ENTRY - 1], CPU)


@pytest.mark.cuda
def test_cuda_w3d_round_trip(tissue):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    K.ycocgr_forward.launches = K.ycocgr_inverse.launches = 0
    blob = port.w3d_compress(tissue, W, H, dev, tile_w=TW, tile_h=TH, device_encode=True)
    assert blob == port.w3d_compress(tissue, W, H, CPU, tile_w=TW, tile_h=TH, device_encode=True)
    rgb, w, h = port.w3d_decompress_level(blob, dev, 0)
    assert (w, h) == (W, H) and np.array_equal(rgb, tissue)
    lvl1 = port.w3d_decompress_level(blob, dev, 1)
    assert np.array_equal(lvl1[0], pyramid.downsample2x_rgb(tissue, W, H)[0])
    assert K.ycocgr_forward.launches == 1 and K.ycocgr_inverse.launches == 2
