"""The transform kernels: lossless YCoCg-R and the 5/3 lifting wavelet.

Counterpart of ``mic_tpu.tpu.kernels``:

* ``ycocgr_forward`` / ``ycocgr_inverse`` — the wrappers of the two
  YCoCg-R kernels of ``csrc/transforms.cu`` on three u16 planes;
* ``wt53_rows_forward`` / ``wt53_rows_inverse`` — the wrappers of the two
  5/3 lifting kernels (along axis 1, interleaved output);
* ``wavelet_forward_2d_separated`` / ``wavelet_inverse_2d_separated`` —
  the multi-level 2-D transform into and out of the Mallat layout: the
  transposes, the de-interleave and the level writes are torch ops (XLA
  ops in ``mic_tpu``), the row kernel runs twice a level;

each wrapper with a plain-PyTorch twin (``*_plain``) and a launch counter
(``.launches``).  A wrapper takes the plain version only for tensors on
the CPU; for a CUDA tensor it launches its kernel or raises.

Planes are int16 bit-views of u16 values, as everywhere in the port
(``.numpy().view(np.uint16)`` at the numpy boundary); torch on the CPU
has no uint16 arithmetic, so the plain versions hold the values in int32
and mask.  The YCoCg-R functions take planes of any shape, a batch
``[B, rows, cols]`` included: the transform is per pixel.  For 8-bit RGB
nothing wraps; for arbitrary u16 planes Co and Cg keep their low 16 bits
before the ZigZag and every output its low 16 bits, as the Pallas
kernels' ``astype`` does.  The lifting functions take any integer tensor
``[rows, cols]`` and work in int32, wrapping mod 2^32.
"""

from __future__ import annotations

import torch

__all__ = [
    "ycocgr_forward",
    "ycocgr_forward_plain",
    "ycocgr_inverse",
    "ycocgr_inverse_plain",
    "wt53_rows_forward",
    "wt53_rows_forward_plain",
    "wt53_rows_inverse",
    "wt53_rows_inverse_plain",
    "wavelet_forward_2d_separated",
    "wavelet_inverse_2d_separated",
]


def _check_planes(planes) -> None:
    first = planes[0]
    for i, t in enumerate(planes):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"plane {i}: expected a torch.Tensor")
        if t.dtype != torch.int16:
            raise TypeError(f"plane {i}: expected int16 (bit-view of u16), got {t.dtype}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"plane {i}: {tuple(t.shape)} on {t.device}, plane 0 "
                             f"{tuple(first.shape)} on {first.device}")


def _u16(t: torch.Tensor) -> torch.Tensor:
    """int16 bit-view -> its u16 value in int32."""
    return t.to(torch.int32) & 0xFFFF


def _s16(v: torch.Tensor) -> torch.Tensor:
    """Low 16 bits of an int32 tensor, sign-extended (``astype(int16)``)."""
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000


def ycocgr_forward_plain(r, g, b):
    """Plain-PyTorch twin of the forward YCoCg-R kernel (any device)."""
    _check_planes((r, g, b))
    r, g, b = _u16(r), _u16(g), _u16(b)
    co = r - b
    t = b + (co >> 1)
    cg = g - t
    y = t + (cg >> 1)
    co, cg = _s16(co), _s16(cg)
    return (_s16(y).to(torch.int16),
            _s16((co << 1) ^ (co >> 15)).to(torch.int16),
            _s16((cg << 1) ^ (cg >> 15)).to(torch.int16))


def ycocgr_inverse_plain(y, co, cg):
    """Plain-PyTorch twin of the inverse YCoCg-R kernel (any device)."""
    _check_planes((y, co, cg))
    y, co, cg = _u16(y), _u16(co), _u16(cg)
    co = _s16((co >> 1) ^ -(co & 1))
    cg = _s16((cg >> 1) ^ -(cg & 1))
    t = y - (cg >> 1)
    g = cg + t
    b = t - (co >> 1)
    r = co + b
    return tuple(_s16(v).to(torch.int16) for v in (r, g, b))


def _ycocgr(wrapper, plain, planes, inverse: int):
    _check_planes(planes)
    dev = planes[0].device
    if dev.type == "cpu":
        return plain(*planes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from .._build import kernel_library

    lib = kernel_library()
    ins = [t.contiguous() for t in planes]
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mic_ycocgr(*(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
                            ins[0].numel(), inverse, stream)
    if rc != 0:
        raise RuntimeError(f"mic_ycocgr launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return tuple(outs)


def ycocgr_forward(r, g, b):
    """Planar RGB -> (Y, zigzag Co, zigzag Cg): three int16 bit-view planes
    of one shape in, three out.  CPU tensors take the plain version; CUDA
    tensors launch ``ycocgr_fwd_kernel`` of ``csrc/transforms.cu``
    (non-contiguous planes are copied first)."""
    return _ycocgr(ycocgr_forward, ycocgr_forward_plain, (r, g, b), 0)


ycocgr_forward.launches = 0


def ycocgr_inverse(y, co, cg):
    """(Y, zigzag Co, zigzag Cg) -> planar (R, G, B), the inverse of
    :func:`ycocgr_forward`; launches ``ycocgr_inv_kernel`` on CUDA."""
    return _ycocgr(ycocgr_inverse, ycocgr_inverse_plain, (y, co, cg), 1)


ycocgr_inverse.launches = 0


# ---------------------------------------------------------------------------
# 5/3 lifting, row pass
# ---------------------------------------------------------------------------


def _check_rows(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError("wt53: expected a torch.Tensor")
    if x.dtype not in (torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64):
        raise TypeError(f"wt53: expected an integer tensor, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"wt53: expected [rows, cols], got {tuple(x.shape)}")
    return x.to(torch.int32)


def _d_neighbours(d: torch.Tensor, n: int):
    """(d_left, d_right) of the update step: ``d`` extended by its last
    column for odd ``n``, and shifted right by one with its first column
    repeated."""
    d_right = torch.cat([d, d[:, -1:]], dim=1) if n % 2 else d
    d_left = torch.cat([d_right[:, :1], d[:, : (n + 1) // 2 - 1]], dim=1)
    return d_left, d_right


def _even_right(even: torch.Tensor, n: int) -> torch.Tensor:
    """The right even neighbour of every odd sample (the last even one
    repeated for even ``n``)."""
    return even[:, 1:] if n % 2 else torch.cat([even[:, 1:], even[:, -1:]], dim=1)


def wt53_rows_forward_plain(x) -> torch.Tensor:
    """Plain-PyTorch twin of the forward lifting kernel (any device)."""
    x = _check_rows(x)
    n = x.shape[1]
    if n < 2:
        return x.clone()
    even, odd = x[:, 0::2], x[:, 1::2]
    d = odd - ((even[:, : n // 2] + _even_right(even, n)) >> 1)
    d_left, d_right = _d_neighbours(d, n)
    out = torch.empty_like(x)
    out[:, 0::2] = even + ((d_left + d_right + 2) >> 2)
    out[:, 1::2] = d
    return out


def wt53_rows_inverse_plain(x) -> torch.Tensor:
    """Plain-PyTorch twin of the inverse lifting kernel (any device)."""
    x = _check_rows(x)
    n = x.shape[1]
    if n < 2:
        return x.clone()
    s, d = x[:, 0::2], x[:, 1::2]
    d_left, d_right = _d_neighbours(d, n)
    even = s - ((d_left + d_right + 2) >> 2)
    out = torch.empty_like(x)
    out[:, 0::2] = even
    out[:, 1::2] = d + ((even[:, : n // 2] + _even_right(even, n)) >> 1)
    return out


def _wt53_rows(wrapper, plain, x, inverse: int) -> torch.Tensor:
    x = _check_rows(x)
    if x.device.type == "cpu":
        return plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    rows, n = x.shape
    if n < 2 or rows == 0:  # nothing to lift, as in mic_tpu: no launch
        return x.clone()
    from .._build import kernel_library

    lib = kernel_library()
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mic_wt53_rows(x.data_ptr(), out.data_ptr(), rows, n, inverse, stream)
    if rc != 0:
        raise RuntimeError(f"mic_wt53_rows launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return out


def wt53_rows_forward(x) -> torch.Tensor:
    """Forward 5/3 lifting along axis 1 of an integer tensor [rows, cols]:
    int32 out, s in the even columns and d in the odd ones; ``cols < 2``
    returns the input as int32.  Bit-exact with
    ``mic_tpu.tpu.kernels.wt53_rows_forward_tpu``.  CPU tensors take the
    plain version; CUDA tensors launch ``wt53_fwd_kernel`` of
    ``csrc/transforms.cu`` (a non-contiguous input, a transpose or a crop,
    is copied first)."""
    return _wt53_rows(wt53_rows_forward, wt53_rows_forward_plain, x, 0)


wt53_rows_forward.launches = 0


def wt53_rows_inverse(x) -> torch.Tensor:
    """Inverse of :func:`wt53_rows_forward`; launches ``wt53_inv_kernel``
    on CUDA."""
    return _wt53_rows(wt53_rows_inverse, wt53_rows_inverse_plain, x, 1)


wt53_rows_inverse.launches = 0


# ---------------------------------------------------------------------------
# Multi-level 2-D wavelet
# ---------------------------------------------------------------------------


def _deinterleave_cols(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[:, 0::2], a[:, 1::2]], dim=1)


def _reinterleave_cols(a: torch.Tensor) -> torch.Tensor:
    n_low = (a.shape[1] + 1) // 2
    out = torch.empty_like(a)
    out[:, 0::2] = a[:, :n_low]
    out[:, 1::2] = a[:, n_low:]
    return out


def _level_dims(rows: int, cols: int, levels: int):
    dims = []
    r, c = rows, cols
    for _ in range(levels):
        if r < 2 or c < 2:
            break
        dims.append((r, c))
        r, c = (r + 1) // 2, (c + 1) // 2
    return dims


def wavelet_forward_2d_separated(img: torch.Tensor, *, rows: int, cols: int,
                                 levels: int) -> torch.Tensor:
    """Multi-level forward 5/3 of ``rows * cols`` integer values into the
    Mallat layout, int32 [rows, cols] (counterpart of
    ``wavelet_forward_2d_separated_tpu``)."""
    data = img.to(torch.int32).reshape(rows, cols).clone()
    for r, c in _level_dims(rows, cols, levels):
        region = _deinterleave_cols(wt53_rows_forward(data[:r, :c]))
        data[:r, :c] = _deinterleave_cols(wt53_rows_forward(region.T)).T
    return data


def wavelet_inverse_2d_separated(coeffs: torch.Tensor, *, rows: int, cols: int,
                                 levels: int) -> torch.Tensor:
    """Multi-level inverse 5/3 from the Mallat layout."""
    data = coeffs.to(torch.int32).reshape(rows, cols).clone()
    for r, c in reversed(_level_dims(rows, cols, levels)):
        region = wt53_rows_inverse(_reinterleave_cols(data[:r, :c].T)).T
        data[:r, :c] = wt53_rows_inverse(_reinterleave_cols(region))
    return data
