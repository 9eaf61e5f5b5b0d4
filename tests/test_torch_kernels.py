"""The port's transform kernels against ``mic_tpu.tpu.kernels``.

The plain-PyTorch twins of ``mic_tpu_torch.tpu.kernels`` (what the
wrappers run on CPU tensors) against the Pallas kernels in interpret
mode and against the numpy host ops (``mic_tpu.ops.color``,
``mic_tpu.ops.wavelet``), on whole arrays, tolerance 0: the transforms
are integer and lossless.  Inputs are seeded numpy.  The YCoCg-R planes
are full-range u16, so the int16 wrap of Co / Cg and the u16 wrap of the
outputs are pinned and not only the 8-bit case.  Also pins the host
copies ``ops.color.ycocgr_forward`` and
``ops.predictors.temporal_delta_encode`` to their originals.  The
``cuda`` tests hold each CUDA kernel against its plain twin on the card.
"""

import importlib

import numpy as np
import pytest
import torch

from mic_tpu_torch.ops import color, predictors
from mic_tpu_torch.tpu import kernels as K

COLS = [1, 2, 3, 64, 65, 127, 128]


class _Reference:
    """A module of ``mic_tpu`` or jax, imported at first use: the machine
    that runs the ``cuda`` tests has no jax."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        if name.startswith(("__", "_pytest", "pytest")):  # pytest's collection probes
            raise AttributeError(name)
        pytest.importorskip("jax")
        return getattr(importlib.import_module(self._module), name)


jnp = _Reference("jax.numpy")
ref = _Reference("mic_tpu.tpu.kernels")
ref_color = _Reference("mic_tpu.ops.color")
ref_pred = _Reference("mic_tpu.ops.predictors")
ref_wavelet = _Reference("mic_tpu.ops.wavelet")


def _i16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16))


def _u16(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint16)


def _planes(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 65536, shape).astype(np.uint16) for _ in range(3)]


@pytest.mark.parametrize("shape", [(32, 128), (5, 7), (3, 1), (2, 16, 24)])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_ycocgr_plain_equals_pallas_full_range(direction, shape):
    planes = _planes(len(shape) * 100 + shape[-1], shape)
    fn = getattr(K, f"ycocgr_{direction}")
    ref_fn = getattr(ref, f"ycocgr_{direction}_tpu")
    got = fn(*(_i16(p) for p in planes))
    want = ref_fn(*(jnp.asarray(p) for p in planes))
    for g, w in zip(got, want):
        assert g.dtype == torch.int16 and np.array_equal(_u16(g), np.asarray(w))
    assert fn.launches == 0  # CPU tensors take the plain twin


def test_ycocgr_wrap_cases():
    """Hand-picked operands around the int16 and u16 wraps."""
    v = np.array([0, 1, 255, 256, 32767, 32768, 32769, 65534, 65535], np.uint16)
    r, g, b = (a.ravel() for a in np.meshgrid(v, v, v, indexing="ij"))
    for name in ("forward", "inverse"):
        got = getattr(K, f"ycocgr_{name}")(_i16(r), _i16(g), _i16(b))
        want = getattr(ref, f"ycocgr_{name}_tpu")(*(jnp.asarray(a.reshape(1, -1))
                                                    for a in (r, g, b)))
        for x, w in zip(got, want):
            assert np.array_equal(_u16(x), np.asarray(w).ravel())


def test_ycocgr_equals_host_ops_on_rgb():
    """8-bit RGB: the kernels' planes equal ops.color's, and the inverse
    gives the bytes back; the port's host copies equal the originals."""
    rng = np.random.default_rng(5)
    h, w = 24, 40
    rgb = rng.integers(0, 256, h * w * 3).astype(np.uint8)
    want = ref_color.ycocgr_forward(rgb, w, h)
    copy = color.ycocgr_forward(rgb, w, h)
    for c, x in zip(copy, want):
        assert c.dtype == x.dtype and np.array_equal(c, x)
    px = rgb.reshape(-1, 3).astype(np.uint16)
    got = K.ycocgr_forward(*(_i16(px[:, c].reshape(h, w)) for c in range(3)))
    for g, x in zip(got, want):
        assert np.array_equal(_u16(g).ravel(), x)
    back = K.ycocgr_inverse(*got)
    assert np.array_equal(np.stack([_u16(t) for t in back], -1).astype(np.uint8).ravel(), rgb)
    assert np.array_equal(color.ycocgr_inverse(*want, w, h), rgb)


def test_ycocgr_non_contiguous_and_checks():
    planes = _planes(9, (16, 48))
    want = K.ycocgr_forward(*(_i16(p[:, 3:40]) for p in planes))
    views = [_i16(p)[:, 3:40] for p in planes]
    assert not views[0].is_contiguous()
    got = K.ycocgr_forward(*views)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(TypeError):
        K.ycocgr_forward(*(v.to(torch.int32) for v in views))
    with pytest.raises(ValueError):
        K.ycocgr_inverse(views[0], views[1], views[2][:, :5])


@pytest.mark.parametrize("cols", COLS)
def test_wt53_rows_plain_equals_pallas_and_host(cols):
    rng = np.random.default_rng(cols)
    x = rng.integers(0, 65536, (48, cols)).astype(np.int32)
    got = K.wt53_rows_forward(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(ref.wt53_rows_forward_tpu(jnp.asarray(x))))
    if cols >= 2:
        want = ref_wavelet.wt53_forward_1d(x.astype(np.int64), axis=1)
        assert np.array_equal(got.numpy(), want.astype(np.int32))
    inv = K.wt53_rows_inverse(torch.from_numpy(x))  # any operand, not only coefficients
    assert np.array_equal(inv.numpy(), np.asarray(ref.wt53_rows_inverse_tpu(jnp.asarray(x))))
    assert np.array_equal(K.wt53_rows_inverse(got).numpy(), x)
    assert K.wt53_rows_forward.launches == 0 and K.wt53_rows_inverse.launches == 0


@pytest.mark.parametrize("cols", [2, 3, 4, 5, 66])
def test_wt53_rows_wraps_like_pallas(cols):
    """Full-range int32 operands: sums wrap mod 2^32 on both sides."""
    rng = np.random.default_rng(100 + cols)
    x = rng.integers(-2**31, 2**31, (7, cols)).astype(np.int32)
    for name in ("forward", "inverse"):
        got = getattr(K, f"wt53_rows_{name}")(torch.from_numpy(x))
        want = getattr(ref, f"wt53_rows_{name}_tpu")(jnp.asarray(x))
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_wt53_rows_non_contiguous_and_dtypes():
    rng = np.random.default_rng(21)
    x = rng.integers(0, 4096, (20, 33)).astype(np.int32)
    t = torch.from_numpy(x)
    want = K.wt53_rows_forward(torch.from_numpy(np.ascontiguousarray(x.T)))
    assert torch.equal(K.wt53_rows_forward(t.T), want)  # a transpose
    assert torch.equal(K.wt53_rows_forward(t[:, 2:30]),
                       K.wt53_rows_forward(t[:, 2:30].contiguous()))  # a crop
    assert torch.equal(K.wt53_rows_forward(t.to(torch.int16)), K.wt53_rows_forward(t))
    with pytest.raises(TypeError):
        K.wt53_rows_forward(t.to(torch.float32))
    with pytest.raises(ValueError):
        K.wt53_rows_inverse(t.reshape(-1))


@pytest.mark.parametrize("shape,levels", [((64, 64), 3), ((33, 47), 2), ((5, 2), 4), ((1, 9), 2)])
def test_wavelet_2d_separated_equals_pallas_and_host(shape, levels):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    r, c = shape
    img = rng.integers(0, 4096, (r, c)).astype(np.int32)
    got = K.wavelet_forward_2d_separated(torch.from_numpy(img).reshape(-1), rows=r, cols=c,
                                         levels=levels)
    want = ref.wavelet_forward_2d_separated_tpu(jnp.asarray(img), rows=r, cols=c, levels=levels)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))
    host = img.astype(np.int64)
    rr, cc = r, c
    for _ in range(levels):
        if rr < 2 or cc < 2:
            break
        ref_wavelet.wt53_forward_2d_separated(host, rr, cc, c)
        rr, cc = (rr + 1) // 2, (cc + 1) // 2
    assert np.array_equal(got.numpy(), host.reshape(r, c).astype(np.int32))
    back = K.wavelet_inverse_2d_separated(got, rows=r, cols=c, levels=levels)
    assert np.array_equal(back.numpy(), img)
    assert np.array_equal(back.numpy(), np.asarray(
        ref.wavelet_inverse_2d_separated_tpu(want, rows=r, cols=c, levels=levels)))


def test_temporal_delta_encode_copy_matches():
    rng = np.random.default_rng(12)
    cur = rng.integers(0, 65536, 5000).astype(np.uint16)
    prev = rng.integers(0, 65536, 5000).astype(np.uint16)
    got, want = predictors.temporal_delta_encode(cur, prev), ref_pred.temporal_delta_encode(cur, prev)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(predictors.temporal_delta_decode(got, prev), cur)
    first = predictors.temporal_delta_encode(cur, None)
    assert np.array_equal(first, cur) and first is not cur


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 8, 4096, 512 * 384 + 3])
def test_cuda_ycocgr_kernels_equal_plain(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    planes = [_i16(p).to(dev) for p in _planes(n, (n,))]
    for kernel, plain in ((K.ycocgr_forward, K.ycocgr_forward_plain),
                          (K.ycocgr_inverse, K.ycocgr_inverse_plain)):
        before = kernel.launches
        got = kernel(*planes)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert all(torch.equal(g, w) for g, w in zip(got, plain(*planes)))
        # planes that start 2 bytes past a 16-byte boundary take the scalar path
        shifted = [p[1:] for p in planes]
        assert all(torch.equal(g, w) for g, w in zip(kernel(*shifted), plain(*shifted)))


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [1, 2, 3, 4, 5, 64, 65, 127, 128, 1001])
def test_cuda_wt53_kernels_equal_plain(cols):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(cols)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (300, cols)).astype(np.int32)).cuda()
    for kernel, plain in ((K.wt53_rows_forward, K.wt53_rows_forward_plain),
                          (K.wt53_rows_inverse, K.wt53_rows_inverse_plain)):
        before = kernel.launches
        got = kernel(x)
        torch.cuda.synchronize()
        assert kernel.launches == before + (cols >= 2)
        assert torch.equal(got, plain(x))
        assert torch.equal(kernel(x.T[: max(cols // 2, 1)]), plain(x.T[: max(cols // 2, 1)]))


@pytest.mark.cuda
def test_cuda_wavelet_2d_round_trip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(0, 65536, (1001, 749)).astype(np.int32))
    want = K.wavelet_forward_2d_separated(img, rows=1001, cols=749, levels=5)
    got = K.wavelet_forward_2d_separated(img.cuda(), rows=1001, cols=749, levels=5)
    assert torch.equal(got.cpu(), want)
    back = K.wavelet_inverse_2d_separated(got, rows=1001, cols=749, levels=5)
    assert torch.equal(back.cpu(), img)
