"""The port's MWR3 container (``mic_tpu_torch.tpu.rgb_device``) and the
device-resident assemble against ``mic_tpu.tpu.rgb_device``.

Tolerance 0: decodes are bit-exact and containers byte-identical.  The
images are ``web/testdata/tissue_dev.raw`` (512x384 RGB), crops of it, a
756-wide image (planes edge-padded to 768 and cropped on decode) and a
1024-wide image (planes stored banded).  On CPU tensors the port runs its
kernels' plain twins; ``mic_tpu`` runs its Pallas kernels in interpret
mode.  The alias / best containers are also decoded through ``mic_tpu``'s
device path, the probe for its unexplained fault on the VL1 image under
``entropy="best"``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mic_tpu_torch import MicwDecodePlan, micw_compress_device_many
from mic_tpu_torch.tpu import kernels as K
from mic_tpu_torch.tpu import rgb_device as port
from mic_tpu_torch.tpu.strips import FLAG_BANDED, STRIP_MODE_CONST, STRIP_MODE_RAW, micw_parse

CPU = torch.device("cpu")
TESTDATA = Path(__file__).resolve().parent.parent / "web" / "testdata"
ENTROPIES = ["standard", "alias", "best"]


class _Reference:
    """``mic_tpu.tpu.rgb_device``, imported at first use: the machine that
    runs the ``cuda`` tests has no jax."""

    def __getattr__(self, name):
        if name.startswith(("__", "_pytest", "pytest")):  # pytest's collection probes
            raise AttributeError(name)
        pytest.importorskip("jax")
        from mic_tpu.tpu import rgb_device

        return getattr(rgb_device, name)


ref = _Reference()


def _tissue():
    return np.fromfile(TESTDATA / "tissue_dev.raw", np.uint8).reshape(384, 512, 3)


def _image(name):
    """(interleaved bytes, width, height) of a named test image."""
    t = _tissue()
    img = {"crop128": t[128:256, 192:320],
           "w756": np.concatenate([t[100:132], t[100:132, 128:372]], axis=1),
           "w1024": np.concatenate([t[100:132], t[100:132, ::-1]], axis=1),
           "w100": t[100:164, 200:300]}[name]
    return np.ascontiguousarray(img).reshape(-1), img.shape[1], img.shape[0]


def test_fixture_decodes_like_reference():
    blob = (TESTDATA / "tissue_dev.mwr3").read_bytes()
    K.ycocgr_inverse.launches = 0
    (rgb, w, h), = port.micwr_decode_many([blob], CPU)
    assert (w, h) == (512, 384) and rgb.dtype == np.uint8
    assert np.array_equal(rgb, _tissue().reshape(-1))
    want, rw, rh = ref.micwr_decompress_host(blob)
    assert (rw, rh) == (w, h) and np.array_equal(rgb, want)
    assert K.ycocgr_inverse.launches == 0  # CPU tensors: the plain twin
    one = port.micwr_decompress_device(blob, CPU)
    assert np.array_equal(one[0], rgb) and one[1:] == (w, h)


def test_fixture_decodes_like_reference_device_path():
    """mic_tpu's own batched device decode (Pallas, interpret mode) of the
    fixture twice in one batch against the port's."""
    blob = (TESTDATA / "tissue_dev.mwr3").read_bytes()
    want = ref.micwr_decode_many([blob, blob])
    got = port.micwr_decode_many([blob, blob], CPU)
    for (g, gw, gh), (x, xw, xh) in zip(got, want):
        assert (gw, gh) == (xw, xh) and np.array_equal(g, np.asarray(x, np.uint8))


def test_fixture_encode_is_byte_identical():
    """micwr_compress with its defaults reproduces tissue_dev.mwr3, which
    mic_tpu's host trial set wrote."""
    blob = (TESTDATA / "tissue_dev.mwr3").read_bytes()
    assert port.micwr_compress(_tissue().reshape(-1), 512, 384, CPU) == blob


@pytest.mark.parametrize("entropy", ENTROPIES)
@pytest.mark.parametrize("name", ["crop128", "w756", "w1024"])
def test_micwr_compress_matches_reference(name, entropy):
    rgb, w, h = _image(name)
    got = port.micwr_compress(rgb, w, h, CPU, entropy=entropy)
    assert got == ref.micwr_compress(rgb, w, h, entropy=entropy)
    pw, ph, _planes = port._parse(got)
    assert (pw, ph) == (w, h)
    plane = micw_parse(_planes[0])
    if name == "w756":
        assert plane[0] == 768  # the plane's own header carries the padded width
    if name == "w1024":
        assert _planes[0][22] & FLAG_BANDED and plane[0] == 512
    (out, ow, oh), = port.micwr_decode_many([got], CPU)
    assert (ow, oh) == (w, h) and np.array_equal(out, rgb)
    # mic_tpu on the same container: its device path (Pallas, interpret
    # mode, slow to trace) for the best containers and one alias one, its
    # host decoder otherwise
    if entropy == "standard" or (entropy == "alias" and name != "crop128"):
        rout, rw, rh = ref.micwr_decompress_host(got)
    else:
        (rout, rw, rh), = ref.micwr_decode_many([got])
    assert (rw, rh) == (w, h) and np.array_equal(np.asarray(rout, np.uint8), rgb)


@pytest.mark.parametrize("entropy", ENTROPIES)
def test_micwr_compress_device_many_matches_reference(entropy):
    rgbs = [_image(n) for n in ("crop128", "w100", "w756", "w1024")]
    K.ycocgr_forward.launches = 0
    got = port.micwr_compress_device_many(rgbs, CPU, entropy=entropy)
    want = [ref.micwr_compress(rgb, w, h, predictor="zzd", entropy=entropy) for rgb, w, h in rgbs]
    assert got == want
    assert port.micwr_compress_device(*rgbs[1], CPU, entropy=entropy) == want[1]
    assert K.ycocgr_forward.launches == 0
    outs = port.micwr_decode_many(got, CPU)  # mixed geometries in one plan
    for (out, ow, oh), (rgb, w, h) in zip(outs, rgbs):
        assert (ow, oh) == (w, h) and np.array_equal(out, rgb)


def test_num_strips_and_predictor_pass_through():
    rgb, w, h = _image("crop128")
    got = port.micwr_compress(rgb, w, h, CPU, num_strips=4, predictor="auto-fast")
    assert got == ref.micwr_compress(rgb, w, h, num_strips=4, predictor="auto-fast")
    assert micw_parse(port._parse(got)[2][0])[2] == 4


def test_grey_image_raises_like_reference():
    """A plane whose maximum is 0 (Co and Cg of a grey image) has no
    delta parameters: both packages raise ValueError."""
    grey = np.repeat(np.arange(64 * 128, dtype=np.uint8), 3)
    with pytest.raises(ValueError):
        ref.micwr_compress(grey, 128, 64)
    with pytest.raises(ValueError):
        port.micwr_compress(grey, 128, 64, CPU)


def test_pixel_count_mismatch_raises():
    with pytest.raises(ValueError):
        port.micwr_compress(np.zeros(10, np.uint8), 4, 4, CPU)


def _mixed_batch():
    """MICW containers with fused, post-path, banded, raw and constant
    strips, of several geometries."""
    rng = np.random.default_rng(7)
    t = _tissue()
    noise = rng.integers(0, 65536, 128 * 64).astype(np.uint16)  # incompressible: raw strips
    flat = np.full(256 * 64, 77, np.uint16)  # a constant strip, then a compressible one
    flat[32 * 256:] = rng.integers(0, 50, 32 * 256)
    half = np.concatenate([np.full(128 * 32, 9, np.uint16),
                           t[100:132, 128:256, 1].astype(np.uint16).ravel()])
    wide = np.concatenate([t[100:132, :, 1], t[100:132, ::-1, 1]], axis=1).astype(np.uint16)
    odd = t[100:140, 100:300, 0].astype(np.uint16)
    images = [(noise, 128, 64, 65535, 2), (flat, 256, 64, 77, 2), (half, 128, 64, 255, 2),
              (wide.ravel(), 1024, 32, 255), (np.ascontiguousarray(odd).ravel(), 200, 40, 255)]
    blobs = micw_compress_device_many(images, CPU, predictor="auto")
    blobs += [(TESTDATA / "MR_dev_auto.micw").read_bytes(),
              (TESTDATA / "wide_banded.micw").read_bytes()]
    expected = [im[0] for im in images] + [np.fromfile(TESTDATA / "MR_dev_auto.raw", "<u2"),
                                            np.fromfile(TESTDATA / "wide_banded.raw", "<u2")]
    return blobs, expected


def test_assemble_device_equals_assemble_on_mixed_batch():
    blobs, expected = _mixed_batch()
    modes = {st[5] for b in blobs for st in micw_parse(b)[7]}
    assert STRIP_MODE_RAW in modes and STRIP_MODE_CONST in modes
    assert sum(1 for b in blobs if b[22] & FLAG_BANDED) == 2
    plan = MicwDecodePlan(blobs, CPU)
    assert any(k[0] == "post" for k in plan.buckets) and any(k[0] != "post" for k in plan.buckets)
    decoded = plan.run()
    host = plan.assemble(decoded)
    for _ in range(2):  # the second call reuses the plan's copy lists
        dev = plan.assemble_device(decoded)
        assert len(dev) == len(host)
        for (px, w, h), (dpx, dw, dh), exp in zip(host, dev, expected):
            assert (w, h) == (dw, dh) and dpx.dtype == torch.int16 and dpx.shape == (w * h,)
            assert np.array_equal(dpx.numpy().view(np.uint16), px)
            assert np.array_equal(px, exp)


@pytest.mark.cuda
def test_cuda_mwr3_round_trip_through_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    blob = (TESTDATA / "tissue_dev.mwr3").read_bytes()
    K.ycocgr_inverse.launches = K.ycocgr_forward.launches = 0
    rgbs = [_image(n) for n in ("crop128", "w100", "w756", "w1024")]
    made = port.micwr_compress_device_many(rgbs, dev, entropy="best")
    assert made == port.micwr_compress_device_many(rgbs, CPU, entropy="best")
    assert K.ycocgr_forward.launches == 1
    outs = port.micwr_decode_many(made + [blob], dev)
    assert K.ycocgr_inverse.launches == 5  # one per distinct (width, height)
    for (out, ow, oh), (rgb, w, h) in zip(outs, rgbs + [(_tissue().reshape(-1), 512, 384)]):
        assert (ow, oh) == (w, h) and np.array_equal(out, rgb)
    blobs, expected = _mixed_batch()
    plan = MicwDecodePlan(blobs, dev)
    for (px, _w, _h), exp in zip(plan.assemble_device(plan.run()), expected):
        assert np.array_equal(px.cpu().numpy().view(np.uint16), exp)
