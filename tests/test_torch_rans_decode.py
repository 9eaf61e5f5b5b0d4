"""The port's fused rANS decode kernels against mic_tpu's Pallas kernels.

Both sides get the same numpy ``uint32`` operands, built by mic_tpu's
own builders from numpy-seeded data: ``rans_decode_pallas_zzd`` /
``rans_decode_pallas_alias`` run in interpret mode on the CPU, the port's
``rans_decode_zzd`` / ``rans_decode_alias`` run their plain PyTorch
versions (CPU tensors).  Tolerance 0 on the WHOLE output array, padding
steps included: this is a lossless integer codec.

The ``cuda`` tests hold each CUDA kernel against its plain version on the
card, on operands from the in-repo fixtures; they need no jax, so on a
machine with a GPU and no jax they run with
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_rans_decode.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mic_tpu_torch.tpu import rans_decode as rd

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ref():
    """mic_tpu's encoders, builders and Pallas kernels (needs jax)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from mic_tpu.tpu import device_rans, pallas_rans, strips

    return jnp, device_rans, pallas_rans, strips


def _smooth(rng, h, w, axis=1, scale=9, base=600):
    img = rng.standard_normal((h, w)).cumsum(axis=axis) * scale + base
    return img.clip(0, 4095).astype(np.uint16)


def _spiky(rng, h, w, axis=1):
    """Smooth base plus salt spikes: the delta alphabet exceeds the 255
    kept alias symbols, so escape folding triggers."""
    img = _smooth(rng, h, w, axis).astype(np.int64)
    m = rng.random((h, w)) < 0.03
    return np.where(m, rng.integers(0, 4095, (h, w)), img).astype(np.uint16)


def _ws(widths):
    return np.repeat(np.array([w // 128 for w in widths], np.uint32)[:, None], 128, 1)


def _port(fn, ops, **kw):
    return fn(*rd.to_device(ops, "cpu"), **kw).numpy().view(np.uint16)


def _zzd_both(ref, parsed, widths, vdd_ws=0):
    jnp, _dr, pr, _st = ref
    tl = max(max(p[1] for p in parsed), 7)
    init, tpk, alpha, words, mask, shift, _c, steps, asweep = \
        pr.build_packed_tables(parsed, tl)
    ops = (init, tpk, alpha, words, mask, shift, _ws(widths))
    want = np.asarray(pr.rans_decode_pallas_zzd(
        *map(jnp.asarray, ops), steps=steps, n_strips=len(parsed), table_log=tl,
        asweep=asweep, vdd_ws=vdd_ws))
    got = _port(rd.rans_decode_zzd, ops, steps=steps, vdd_ws=vdd_ws)
    return want, got


def _alias_both(ref, parsed, widths, vdd_ws=0, fused=True, esc=True):
    jnp, _dr, pr, _st = ref
    built = pr.build_alias_bucket_tables(parsed)
    ops = built[:9] + (_ws(widths),)
    steps = built[10]
    want = np.asarray(pr.rans_decode_pallas_alias(
        *map(jnp.asarray, ops), steps=steps, n_strips=len(parsed),
        vdd_ws=vdd_ws, fused=fused, esc=esc))
    got = _port(rd.rans_decode_alias, ops, steps=steps, vdd_ws=vdd_ws,
                fused=fused, esc=esc)
    return want, got


def test_zzd_mixed_widths(ref):
    """FF 57 zzd strips of three widths in one batch: the per-strip ws
    row reset and the padding steps of the shorter strip."""
    _jnp, dr, _pr, st = ref
    rng = np.random.default_rng(11)
    parsed, pixels = [], []
    for w, sh in ((128, 4), (256, 4), (512, 2)):
        px = _smooth(rng, sh, w).ravel()
        parsed.append(dr.mict_parse(dr.mict_encode(st._zzd_syms(px, w, sh),
                                                   lanes=128, table_log=11)))
        pixels.append(px)
    want, got = _zzd_both(ref, parsed, (128, 256, 512))
    assert np.array_equal(got, want)
    for i, px in enumerate(pixels):
        assert np.array_equal(got[i].reshape(-1)[: px.size], px), f"strip {i}"


@pytest.mark.parametrize("vdd_ws", [1, 2, 4])
def test_vdd(ref, vdd_ws):
    _jnp, dr, _pr, st = ref
    rng = np.random.default_rng(20 + vdd_ws)
    w, sh = 128 * vdd_ws, 8 // vdd_ws
    pixels, parsed = [], []
    for _ in range(2):
        px = _smooth(rng, sh, w, axis=0, scale=7, base=900).ravel()
        parsed.append(dr.mict_parse(dr.mict_encode(st._vdd_syms(px, w, sh),
                                                   lanes=128, table_log=10)))
        pixels.append(px)
    want, got = _zzd_both(ref, parsed, (w, w), vdd_ws=vdd_ws)
    assert np.array_equal(got, want)
    for i, px in enumerate(pixels):
        assert np.array_equal(got[i].reshape(-1)[: px.size], px)


def test_alias_raw_symbols(ref):
    """Alias symbols (fused=False) at tableLogs 10, 11 and 12 in one
    batch; the tl-12 stream is escape-heavy, as test_alias_kernel builds
    it.  Stream length caps the tableLog (at log2(n) - 2)."""
    _jnp, dr, _pr, _st = ref
    rng = np.random.default_rng(0)
    parsed, expected = [], []
    for n, esc_heavy in ((5000, False), (9000, False), (16500, True)):
        if esc_heavy:
            base = np.minimum(rng.geometric(0.15, n), 30).astype(np.uint16)
            tail = rng.integers(0, 4000, n).astype(np.uint16)
            data = np.where(rng.random(n) < 0.08, tail, base)
        else:
            data = np.minimum(rng.geometric(0.08, n), 299).astype(np.uint16)
        parsed.append(dr.mict_parse(dr.mict_encode_alias(data, table_log=12)))
        expected.append(data)
    assert [p[1] for p in parsed] == [10, 11, 12]
    assert len(parsed[2][7][1]) > 0, "no escapes triggered"
    want, got = _alias_both(ref, parsed, (128,) * 3, fused=False)
    assert np.array_equal(got, want)
    for i, data in enumerate(expected):
        assert np.array_equal(got[i].reshape(-1)[: data.size], data), f"strip {i}"


@pytest.mark.parametrize("pred", ["zzd", "vdd"])
@pytest.mark.parametrize("esc", [True, False], ids=["esc_on", "esc_off"])
def test_alias_fused(ref, pred, esc):
    """Fused alias zzd / vdd over escape-folded strips, with the escape
    machinery on (the pixels come back) and off (the substitution is
    skipped: the port must still agree with the Pallas kernel on the
    whole, then wrong, output).  Escape-free fused strips are covered by
    the plan tests on the CT_dev_alias fixture."""
    _jnp, dr, _pr, st = ref
    rng = np.random.default_rng(30)
    w, sh = 256, 12
    axis = 1 if pred == "zzd" else 0
    syms_fn = st._zzd_syms if pred == "zzd" else st._vdd_syms
    parsed, pixels = [], []
    for _ in range(2):
        px = _spiky(rng, sh, w, axis).ravel()
        parsed.append(dr.mict_parse(dr.mict_encode_alias(syms_fn(px, w, sh),
                                                         table_log=11)))
        pixels.append(px)
    assert all(len(p[7][1]) for p in parsed), "no escapes triggered"
    vdd_ws = w // 128 if pred == "vdd" else 0
    want, got = _alias_both(ref, parsed, (w, w), vdd_ws=vdd_ws, esc=esc)
    assert np.array_equal(got, want)
    decoded = [np.array_equal(got[i].reshape(-1)[: px.size], px)
               for i, px in enumerate(pixels)]
    assert all(decoded) if esc else not any(decoded)


# ---------------------------------------------------------------------------
# Wrapper contract (CPU)
# ---------------------------------------------------------------------------


def _fixture_buckets(names, device):
    from mic_tpu_torch import MicwDecodePlan

    blobs = [(ROOT / n).read_bytes() for n in names]
    return MicwDecodePlan(blobs, device).buckets


def test_wrapper_cpu_takes_plain_and_counts_nothing():
    (b,) = _fixture_buckets(["web/testdata/MR_dev.micw"], "cpu").values()
    before = rd.rans_decode_zzd.launches
    out = rd.rans_decode_zzd(*b.ops, **b.kwargs)
    assert rd.rans_decode_zzd.launches == before
    assert torch.equal(out, rd.rans_decode_zzd_plain(*b.ops, **b.kwargs))


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguity", "device", "steps", "vdd_ws"])
def test_wrapper_rejects_bad_operands(fault):
    (b,) = _fixture_buckets(["web/testdata/MR_dev_alias.micw"], "cpu").values()
    ops, kw = list(b.ops), dict(b.kwargs)
    if fault == "dtype":
        ops[0] = ops[0].to(torch.int64)
    elif fault == "shape":
        ops[1] = ops[1][:, :64].contiguous()
    elif fault == "contiguity":
        ops[4] = ops[4].transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "device":
        ops[2] = ops[2].to("meta")
    elif fault == "steps":
        kw["steps"] = kw["steps"] + 4
    else:
        kw["vdd_ws"] = 3
    with pytest.raises((TypeError, ValueError)):
        rd.rans_decode_alias(*ops, **kw)


# ---------------------------------------------------------------------------
# CUDA kernel vs its plain version (on the card; skipped elsewhere)
# ---------------------------------------------------------------------------

_CASES = {
    "zzd_vdd_pdd": ["web/testdata/CT_dev.micw"],
    "alias_vdd_pdd_zzd": ["tests/data/torch_port/CT_dev_alias.micw"],
    "alias_pdd_escapes": ["web/testdata/MR_dev_alias.micw"],
    "banded_pdd": ["web/testdata/wide_banded.micw"],
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_CASES))
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plain = {rd.rans_decode_zzd: rd.rans_decode_zzd_plain,
             rd.rans_decode_alias: rd.rans_decode_alias_plain}
    for b in _fixture_buckets(_CASES[case], "cuda").values():
        variants = [b.kwargs]
        if b.fn is rd.rans_decode_alias:
            variants.append(dict(b.kwargs, vdd_ws=0, fused=False))
        for kw in variants:
            before = b.fn.launches
            got = b.fn(*b.ops, **kw)
            torch.cuda.synchronize()
            assert b.fn.launches == before + 1
            want = plain[b.fn](*b.ops, **kw)
            assert torch.equal(got, want), (case, kw)
