"""The port's post-path decode against mic_tpu.

* (a) the symbols-out kernels' wrappers (plain versions on CPU tensors)
  against ``rans_decode_pallas_packed`` / ``rans_decode_pallas`` in
  interpret mode, whole output arrays, on seeded streams: tableLogs 6-12
  mixed in one bucket, short strips, tableLog 13 with an alphabet over
  4096 (at a reduced step count: interpret mode sweeps 2^tl / 128 table
  tiles a step), and tableLog 15 against ``mict_decode_numpy``;
* (b) each post function of ``mic_tpu_torch.tpu.post`` against its
  ``mic_tpu.tpu.pipeline`` original, strip by strip, on seeded inputs;
* (c) ``MicwDecodePlan`` on the post path's strips (the avg fixture,
  escaped zz / avg in both entropy families, widths that are not a
  multiple of 128, vdd / vdr at width/128 outside {1, 2, 4, 8}, FF 57
  re-encoded at tableLogs 13-15 or with an alphabet over 4096) against
  the pixels and ``micw_decompress_host``, and a small batch against
  ``mic_tpu``'s own plan;
* (d) round trips: the port's device encoder under ``auto``, ``zz``,
  ``avg`` and ``auto-fast`` at odd widths, decoded by the port.

Tolerance 0 everywhere: a lossless codec.

The fixtures ``tests/data/torch_port/CT_dev_tl13.micw`` and
``CT_dev_1strip_tl15.micw`` are CT_dev containers whose strips were
re-encoded at a larger tableLog, as a writer other than ``mic_tpu``'s
encoders (which cap FF 57 at tl 11) may send them; :func:`reencode` wrote
them::

    reencode(web/testdata/CT_dev.micw, 13)
    reencode(micw_compress(px, 512, 512, px.max(), num_strips=1), 15)

The ``cuda`` tests hold both new kernels against their plain versions and
the plan's post buckets against the same plan on the CPU, on the card;
they need no jax, so on a machine with a GPU and no jax they run with
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_post_decode.py``.
"""

import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mic_tpu_torch import (
    MicwDecodePlan,
    micw_compress_device_many,
    micw_decode_many,
    micw_decompress_device,
)
from mic_tpu_torch.ops.rle import soa_encode
from mic_tpu_torch.tpu import post
from mic_tpu_torch.tpu import rans_decode as rd
from mic_tpu_torch.tpu import strips as st
from mic_tpu_torch.tpu.device_rans import mict_parse

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "web" / "testdata"
PORT_DATA = ROOT / "tests" / "data" / "torch_port"
CPU = torch.device("cpu")
REENCODED = {13: PORT_DATA / "CT_dev_tl13.micw", 15: PORT_DATA / "CT_dev_1strip_tl15.micw"}
PLAIN = {rd.rans_decode_packed: rd.rans_decode_packed_plain,
         rd.rans_decode: rd.rans_decode_plain,
         rd.rans_decode_alias: rd.rans_decode_alias_plain}


@pytest.fixture(scope="module")
def ref():
    """mic_tpu's device tier (needs jax)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from mic_tpu.tpu import device_rans, pallas_rans, pipeline, strips

    return SimpleNamespace(jnp=jnp, dr=device_rans, pr=pallas_rans, pl=pipeline, st=strips)


def _smooth(rng, h, w, axis=1, scale=9, base=700):
    img = rng.standard_normal((h, w)).cumsum(axis=axis) * scale + base
    return img.clip(0, 4095).astype(np.uint16)


def _ct():
    return np.fromfile(TESTDATA / "CT_dev.raw", dtype="<u2")


def _container(strip_blobs, entries, width, height, strip_h, max_value, flags=st.FLAG_ADAPTIVE):
    """A MICW container of the given MICT blobs and table entries
    (n_soa, n_tok, n_runs, n_same, mode)."""
    out = bytearray(b"MICW" + struct.pack("<IIII", width, height, len(strip_blobs), strip_h)
                    + struct.pack("<HBB", max_value, flags, 7))
    off = 0
    for b, e in zip(strip_blobs, entries):
        out += struct.pack("<IIIIIII", off, len(b), *e)
        off += len(b)
    return bytes(out) + b"".join(strip_blobs)


def reencode(ref, blob, table_log):
    """``blob`` with every entropy strip's symbols re-encoded as FF 57 by
    ``mict_encode(..., table_log=table_log)``; the table entries and the
    header (FLAG_BANDED extension included) stay."""
    w, h, _ns, sh, mv, gpred, lanes, strips = ref.st.micw_parse(blob)
    hdr = st.MICW_HEADER + (8 if blob[22] & st.FLAG_BANDED else 0)
    blobs = []
    for s in strips:
        b = s[0]
        if ref.st.strip_predictor(gpred, s[5]) is not None:
            b = ref.dr.mict_encode(ref.dr.mict_decode_numpy(b), lanes=lanes,
                                   table_log=table_log)
        blobs.append(b)
    body = _container(blobs, [s[1:6] for s in strips], w, h, sh, mv)
    return blob[:hdr] + body[st.MICW_HEADER:]


def _decode_ok(blob, px, ref=None):
    out, w, h = micw_decompress_device(blob, CPU)
    assert out.dtype == np.uint16 and np.array_equal(out, px)
    if ref is not None:
        host, hw, hh = ref.st.micw_decompress_host(blob)
        assert (hw, hh) == (w, h) and np.array_equal(out, np.asarray(host).ravel())


# ---------------------------------------------------------------------------
# (a) the symbols-out kernels against Pallas
# ---------------------------------------------------------------------------


def _streams(ref, specs, seed):
    """(symbols, parsed FF 57 stream) pairs of geometric symbols: specs =
    [(n, table_log, alphabet cap)]."""
    rng = np.random.default_rng(seed)
    out = []
    for n, tl, cap in specs:
        data = np.minimum(rng.geometric(4.0 / cap, n), cap).astype(np.uint16)
        out.append((data, ref.dr.mict_parse(ref.dr.mict_encode(data, lanes=128, table_log=tl))))
    return out


def _noise_stream(ref, n=60000, seed=13):
    """1500 |N(0, 1)| symbols: tl 13 with an alphabet over 4096."""
    rng = np.random.default_rng(seed)
    data = (np.abs(rng.standard_normal(n)) * 1500).astype(np.uint16)
    return data, ref.dr.mict_parse(ref.dr.mict_encode(data, lanes=128, table_log=13))


def _port(fn, ops, **kw):
    return fn(*rd.to_device(ops, "cpu"), **kw).numpy().view(np.uint16)


# tableLogs 6-12 in one bucket (tl 6 tiled up to the sweeps' floor of 7
# and beyond); the short streams leave pad steps.
MIXED = [(300, 7, 40), (2500, 9, 200), (9000, 11, 900), (17000, 12, 1500)]


def test_packed_symbols_match_pallas(ref):
    datas, parsed = zip(*_streams(ref, MIXED, 1))
    assert sorted({p[1] for p in parsed}) == [6, 9, 11, 12]
    tl = max(p[1] for p in parsed)
    init, tpk, alpha, words, mask, shift, _c, steps, asweep = \
        ref.pr.build_packed_tables(parsed, tl)
    ops = (init, tpk, alpha, words, mask, shift)
    want = np.asarray(ref.pr.rans_decode_pallas_packed(
        *map(ref.jnp.asarray, ops), steps=steps, n_strips=len(parsed), table_log=tl,
        asweep=asweep))
    got = _port(rd.rans_decode_packed, ops, steps=steps)
    assert np.array_equal(got, want)
    for i, data in enumerate(datas):
        assert np.array_equal(got[i].reshape(-1)[: data.size], data), i


@pytest.mark.parametrize("case", ["mixed_tl", "tl13_alphabet_over_4096"])
def test_two_table_matches_pallas(ref, case):
    if case == "mixed_tl":
        parsed, steps = [p for _d, p in _streams(ref, MIXED, 2)], None
    else:
        _data, noise = _noise_stream(ref)
        assert noise[1] == 13 and np.count_nonzero(noise[5]) > 4096
        parsed, steps = [noise] + [p for _d, p in _streams(ref, [(3000, 10, 300)], 3)], 16
    tl = max(p[1] for p in parsed)
    built = rd.build_pallas_tables(parsed, tl)
    want_built = ref.pr.build_pallas_tables(parsed, tl)
    for a, b in zip(built[:6], want_built[:6]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert built[6:] == want_built[6:]
    steps = steps or built[7]
    want = np.asarray(ref.pr.rans_decode_pallas(
        *map(ref.jnp.asarray, built[:6]), steps=steps, n_strips=len(parsed), table_log=tl))
    got = _port(rd.rans_decode, built[:6], steps=steps)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("table_log", [13, 15])
def test_two_table_symbols_match_numpy(ref, table_log):
    """Whole streams, all steps: the plain twin's symbols == the host
    decoder's (``mict_decode_numpy``), at tl 13 (the noise stream,
    alphabet over 4096) and tl 15 (the one-strip CT fixture), with a tl 9
    stream tiled up beside it."""
    if table_log == 13:
        big = _noise_stream(ref)[1]
        want = [_noise_stream(ref)[0]]
    else:
        blob = st.micw_parse(REENCODED[15].read_bytes())[7][0][0]
        big = mict_parse(blob)
        want = [ref.dr.mict_decode_numpy(blob)[: big[2]]]
    assert big[1] == table_log
    small = _streams(ref, [(2000, 9, 200)], 4)
    parsed = [big] + [p for _d, p in small]
    want += [d for d, _p in small]
    built = rd.build_pallas_tables(parsed, table_log)
    got = _port(rd.rans_decode, built[:6], steps=built[7])
    for i, (p, w) in enumerate(zip(parsed, want)):
        assert np.array_equal(got[i].reshape(-1)[: p[2]], w), i


def test_wrappers_cpu_take_plain_and_count_nothing():
    blob = (TESTDATA / "MR_dev_auto.micw").read_bytes()
    (b,) = MicwDecodePlan([blob], CPU).buckets.values()
    assert b.fn is rd.rans_decode_packed
    before = rd.rans_decode_packed.launches, rd.rans_decode.launches
    assert torch.equal(b.fn(*b.ops, **b.kwargs), rd.rans_decode_packed_plain(*b.ops, **b.kwargs))
    (b2,) = MicwDecodePlan([REENCODED[15].read_bytes()], CPU).buckets.values()
    assert b2.fn is rd.rans_decode
    assert torch.equal(b2.fn(*b2.ops, **b2.kwargs), rd.rans_decode_plain(*b2.ops, **b2.kwargs))
    assert (rd.rans_decode_packed.launches, rd.rans_decode.launches) == before


@pytest.mark.parametrize("fault", ["dtype", "width", "mismatch", "steps", "device"])
def test_wrappers_reject_bad_operands(fault):
    (b,) = MicwDecodePlan([REENCODED[15].read_bytes()], CPU).buckets.values()
    ops, kw = list(b.ops), dict(b.kwargs)
    if fault == "dtype":
        ops[1] = ops[1].to(torch.int64)
    elif fault == "width":
        ops[1] = ops[2] = torch.zeros((1, 1 << 17), dtype=torch.int32)
    elif fault == "mismatch":
        ops[2] = ops[2][:, :128].contiguous()
    elif fault == "steps":
        kw["steps"] = 12
    else:
        ops[0] = ops[0].to("meta")
    with pytest.raises((TypeError, ValueError)):
        rd.rans_decode(*ops, **kw)


# ---------------------------------------------------------------------------
# (b) each post function against its pipeline.py original
# ---------------------------------------------------------------------------


def _escaped(pred, rng, h, w, mv=4095):
    """(tokens without the maxValue word, pixels, delim) of a seeded strip
    with escapes."""
    img = _smooth(rng, h, w, scale=40)
    img[rng.random((h, w)) < 0.08] = rng.integers(0, mv, 1)[0]
    tokens = st._escaped_tokens(img.ravel(), w, h, mv, pred)
    return tokens[1:].astype(np.int64), img.ravel(), st.delta_params(mv)[1]


def _rle_strips(rng, mid, min_same, n=3):
    """(soa, n_runs, n_same, tokens) of seeded token streams with runs."""
    out = []
    for _ in range(n):
        toks = np.repeat(rng.integers(0, 300, 500), rng.integers(1, 25, 500))
        toks = toks[: 1500 + int(rng.integers(0, 1500))].astype(np.uint16)
        out.append((*soa_encode(toks, mid, min_same=min_same), toks))
    return out


POST_CASES = ["soa_expand_rmode", "soa_expand_escaped", "parse_zz", "parse_avg",
              "zz_inverse", "avg_inverse", "zzd_inverse", "vdd_inverse", "pdd_inverse"]


@pytest.mark.parametrize("case", POST_CASES)
def test_post_function_matches_pipeline(ref, case):
    jnp, pl = ref.jnp, ref.pl
    rng = np.random.default_rng(POST_CASES.index(case))
    if case.startswith("soa_expand"):
        mid, min_same = (st.MID_DIRECT, 16) if case.endswith("rmode") else (1023, 3)
        strips = _rle_strips(rng, mid, min_same)
        m = max(len(s[0]) for s in strips) + 200
        syms = np.zeros((len(strips), m), np.int64)
        for i, s in enumerate(strips):
            syms[i, : len(s[0])] = s[0]
        max_runs = 128 * st._pow2_at_least((max(s[1] for s in strips) + 128) // 128)
        max_out = 128 * st._pow2_at_least((max(len(s[3]) for s in strips) + 128) // 128)
        got, n_tok = post.soa_rle_expand(torch.from_numpy(syms), [s[1] for s in strips],
                                         [s[2] for s in strips], mid, max_runs, max_out)
        for i, s in enumerate(strips):
            want, wn = pl.soa_rle_expand_device(jnp.asarray(syms[i].astype(np.int32)),
                                                jnp.int32(s[1]), jnp.int32(s[2]),
                                                jnp.int32(mid), max_runs, max_out)
            assert np.array_equal(got[i].numpy(), np.asarray(want)) and int(n_tok[i]) == int(wn)
            assert np.array_equal(got[i, : len(s[3])].numpy(), s[3])
        return
    h, w = 6, 37
    if case.startswith("parse") or case in ("zz_inverse", "avg_inverse"):
        pred = "avg" if case in ("parse_avg", "avg_inverse") else "zz"
        cases = [_escaped(pred, rng, h, w) for _ in range(3)]
        m = max(len(c[0]) for c in cases) + 5
        toks = np.zeros((3, m), np.int64)
        for i, c in enumerate(cases):
            toks[i, : len(c[0])] = c[0]
        n_tok = [len(c[0]) for c in cases]
        vals, raw = post.parse_escaped(torch.from_numpy(toks), n_tok, cases[0][2], h * w)
        for i, c in enumerate(cases):
            wv, wr = pl.parse_escaped_device(jnp.asarray(toks[i].astype(np.int32)),
                                             jnp.int32(n_tok[i]), jnp.int32(c[2]), h * w)
            assert np.array_equal(vals[i].numpy(), np.asarray(wv))
            assert np.array_equal(raw[i].numpy(), np.asarray(wr))
            if case == "zz_inverse":
                want = pl.zz_delta_inverse_device(wv, wr, jnp.int32(0), w, h)
                got = post.zz_delta_inverse(vals[i:i + 1], raw[i:i + 1], w, h)[0]
            elif case == "avg_inverse":
                want = pl.avg_delta_inverse_device(wv, wr, jnp.int32(c[2] >> 1), w, h)
                got = post.avg_delta_inverse(vals[i:i + 1], raw[i:i + 1], c[2] >> 1, w, h)[0]
            else:
                continue
            assert np.array_equal(got.numpy(), np.asarray(want))
            assert np.array_equal(got.numpy(), c[1])
        return
    fn = {"zzd_inverse": (post.zzd_inverse, pl.zzd_inverse_device),
          "vdd_inverse": (post.vdd_inverse, pl.vdd_inverse_device),
          "pdd_inverse": (post.pdd_inverse, pl.pdd_inverse_device)}[case]
    syms = rng.integers(0, 65536, (3, h * w + 50)).astype(np.int64)
    got = fn[0](torch.from_numpy(syms), w, h)
    for i in range(3):
        want = fn[1](jnp.asarray(syms[i].astype(np.uint16)), w, h)
        assert np.array_equal(got[i].numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# (c) the plan on post-path strips
# ---------------------------------------------------------------------------


def test_avg_fixture(ref):
    """MR_dev_auto.micw, what predictor="auto" writes: two FF 57 avg strips
    (tl 11), one packed post bucket."""
    blob = (TESTDATA / "MR_dev_auto.micw").read_bytes()
    plan = MicwDecodePlan([blob], CPU)
    assert [k[:3] for k in plan.buckets] == [("post", "packed", "avg")]
    _decode_ok(blob, np.fromfile(TESTDATA / "MR_dev_auto.raw", dtype="<u2"), ref)


@pytest.mark.parametrize("pred", ["zz", "avg"])
@pytest.mark.parametrize("ent", ["standard", "alias"])
def test_escaped_modes(ref, pred, ent):
    """zz / avg strips with escapes, a short last strip and a constant
    strip, in both entropy families."""
    rng = np.random.default_rng(5)
    h, w = 40, 256  # strips of 14, 14 and 12 rows
    img = _smooth(rng, h, w)
    img[rng.random((h, w)) < 0.01] = 4000
    img[14:28] = 1234
    px = img.ravel()
    blob = ref.st.micw_compress(px, w, h, int(px.max()), num_strips=3, predictor=pred,
                                entropy=ent)
    modes = [s[5] for s in st.micw_parse(blob)[7]]
    assert modes == [st._PRED_MODE[pred], st.STRIP_MODE_CONST, st._PRED_MODE[pred]]
    forms = {k[1] for k in MicwDecodePlan([blob], CPU).buckets}
    assert forms == {"alias" if ent == "alias" else "packed"}
    _decode_ok(blob, px, ref)


@pytest.mark.parametrize("width", [192, 320, 500, 800])
def test_widths_not_multiple_of_128(ref, width):
    """auto-fast at widths the fused kernels do not take: every strip goes
    to the post path (direct inverses)."""
    rng = np.random.default_rng(width)
    px = _smooth(rng, 48, width).ravel()
    blob = ref.st.micw_compress(px, width, 48, int(px.max()), num_strips=3)
    assert all(k[0] == "post" for k in MicwDecodePlan([blob], CPU).buckets)
    _decode_ok(blob, px, ref)


@pytest.mark.parametrize("pred,width", [("vdd", 384), ("vdd", 640), ("vdr", 384),
                                        ("vdr", 640), ("zzr", 192), ("pdr", 320)])
def test_direct_and_r_modes_on_the_post_path(ref, pred, width):
    rng = np.random.default_rng(width + len(pred))
    img = _smooth(rng, 32, width, axis=0)
    img[:, : width // 3] = 900  # flat region: the r-modes' runs
    px = img.ravel()
    blob = ref.st.micw_compress(px, width, 32, int(px.max()), num_strips=2, predictor=pred)
    assert {s[5] for s in st.micw_parse(blob)[7]} == {st._PRED_MODE[pred]}
    assert {k[:3] for k in MicwDecodePlan([blob], CPU).buckets} == {("post", "packed", pred)}
    _decode_ok(blob, px, ref)


@pytest.mark.parametrize("table_log", [13, 14, 15])
def test_reencoded_large_table_logs(ref, table_log):
    """FF 57 strips at tableLog 13-15: two-table post buckets (tl 13 and
    15 are the committed fixtures, which must not be stale)."""
    px = _ct()
    if table_log == 14:
        one = ref.st.micw_compress(px, 512, 512, int(px.max()), num_strips=2)
        blob = reencode(ref, one, 14)
    else:
        blob = REENCODED[table_log].read_bytes()
        base = (TESTDATA / "CT_dev.micw").read_bytes() if table_log == 13 else \
            ref.st.micw_compress(px, 512, 512, int(px.max()), num_strips=1)
        assert reencode(ref, base, table_log) == blob
    tls = {mict_parse(s[0])[1] for s in st.micw_parse(blob)[7]}
    assert max(tls) == table_log
    assert all(k[:2] == ("post", "two_table") for k in MicwDecodePlan([blob], CPU).buckets)
    _decode_ok(blob, px, ref)


def test_alphabet_over_4096(ref):
    """A zzd strip whose alphabet exceeds the packed tables' 4096 (noise
    diffs), written at tl 13 beside a packed zzd strip of the same width:
    the first takes the two-table post path, the second the fused kernel."""
    rng = np.random.default_rng(17)
    w, sh = 256, 256
    noise = (30000 + rng.standard_normal((sh, w)) * 600).astype(np.uint16).ravel()
    smooth = _smooth(rng, sh, w).ravel()
    syms = [st._zzd_syms(p, w, sh) for p in (noise, smooth)]
    mv = int(max(noise.max(), smooth.max()))
    blobs = [ref.dr.mict_encode(syms[0], lanes=128, table_log=13),
             ref.dr.mict_encode(syms[1], lanes=128, max_table_log=11)]
    blob = _container(blobs, [(len(s), len(s), 0, 0, st.STRIP_MODE_ZZD) for s in syms],
                      w, 2 * sh, sh, mv)
    p0 = mict_parse(blobs[0])
    assert p0[1] == 13 and np.count_nonzero(p0[5]) > 4096
    keys = list(MicwDecodePlan([blob], CPU).buckets)
    assert keys[0][:2] == ("post", "two_table") and keys[1][0] == "zzd"
    _decode_ok(blob, np.concatenate([noise, smooth]), ref)


def test_mixed_batch_matches_mic_tpu_plan(ref):
    """A small batch of post-path containers (zz alias at 192, avg at 136,
    zzr at 192, vdd at 384, zzd re-encoded at tl 13) next to a fused one,
    against mic_tpu's own MicwDecodePlan in interpret mode, image for
    image; the port's plan runs every bucket's entropy stage, the packed,
    two-table and FF 41 post buckets' too, as groups of the direct
    kernel's launch."""
    rng = np.random.default_rng(21)
    blobs, pxs = [], []
    for pred, w, ent in (("zz", 192, "alias"), ("avg", 136, "standard"), ("zzr", 192, "standard"),
                         ("vdd", 384, "standard"), ("zzd", 256, "standard")):
        img = _smooth(rng, 8, w, axis=0 if pred == "vdd" else 1)
        img[:, :40] = 650
        px = img.ravel()
        blobs.append(ref.st.micw_compress(px, w, 8, int(px.max()), num_strips=1,
                                          predictor=pred, entropy=ent))
        pxs.append(px)
    px = _smooth(rng, 160, 256).ravel()  # 40960 symbols: enough for tl 13
    blobs.append(reencode(ref, ref.st.micw_compress(px, 256, 160, int(px.max()), num_strips=1,
                                                    predictor="zzd"), 13))
    pxs.append(px)
    plan = MicwDecodePlan(blobs, CPU)
    forms = {k[1]: plan.buckets[k].fn for k in plan.buckets if k[0] == "post"}
    assert forms == {"alias": rd.rans_decode_alias, "packed": rd.rans_decode_packed,
                     "two_table": rd.rans_decode}
    assert plan._direct_keys == list(plan.buckets)
    want = ref.st.MicwDecodePlan(blobs)
    want = want.assemble(want.run())
    got = plan.assemble(plan.run())
    for (g, gw, gh), (r, rw, rh), px in zip(got, want, pxs):
        assert (gw, gh) == (rw, rh) and np.array_equal(g, np.asarray(r)) and np.array_equal(g, px)


def test_post_params_and_sizing_match_reference(ref):
    """_post_params, and the post buckets' max_runs / max_tokens against
    the sizes mic_tpu's staging closes over (``_stage_mict_group``'s
    post program), for zz, avg, zzr and the direct modes off the fused
    path."""
    for pred in ("zzd", "vdd", "pdd", "zzr", "vdr", "pdr", "zz", "avg"):
        for mid, delim in ((127, 255), (1023, 2047), (32767, 65535)):
            assert st._post_params(pred, mid, delim) == ref.st._post_params(pred, mid, delim)
    rng = np.random.default_rng(31)
    checked = 0
    for pred, w in (("zz", 256), ("avg", 192), ("zzr", 320), ("pdd", 200)):
        img = _smooth(rng, 48, w)
        img[:, : w // 4] = 800
        px = img.ravel()
        blob = ref.st.micw_compress(px, w, 48, int(px.max()), num_strips=3, predictor=pred)
        plan = MicwDecodePlan([blob], CPU)
        _w, _h, _n, sh, mv, _gp, _l, strips = st.micw_parse(blob)
        for b in plan.buckets.values():
            parsed = [mict_parse(s[0]) for s in strips]
            run = ref.st._stage_mict_group(parsed, strips, pred, w, sh, st._rle_mid(mv),
                                           st.delta_params(mv)[1])
            v = dict(zip(run.__code__.co_freevars, (c.cell_contents for c in run.__closure__)))
            if pred in ("zzd", "vdd", "pdd"):
                assert run.__name__ == "run_zzd_post"
                assert (b.post["max_runs"], b.post["max_tokens"]) == (128, 128)
            else:
                assert run.__name__ == "run_rle_post"
                assert (b.post["max_runs"], b.post["max_tokens"]) == (v["max_runs"],
                                                                       v["max_tokens"])
                assert (b.post["mid_count"], b.post["delim"]) == (v["p_mid"], v["p_delim"])
            checked += 1
    assert checked == 4


def test_dishonest_entries_raise():
    blob = bytearray((TESTDATA / "MR_dev_auto.micw").read_bytes())
    good = bytes(blob)
    struct.pack_into("<I", blob, st.MICW_HEADER + 12, 0x7FFFFFFF)  # nTokens of strip 0
    with pytest.raises(ValueError, match="tokens"):
        MicwDecodePlan([bytes(blob)], CPU)
    blob = bytearray(good)
    struct.pack_into("<I", blob, st.MICW_HEADER + 16, 1 << 24)  # nRuns of strip 0
    with pytest.raises(ValueError, match="runs"):
        MicwDecodePlan([bytes(blob)], CPU)


def test_still_out_of_slice():
    """FF 41 strips above tableLog 12 (no encoder writes them) and lanes
    != 128 still raise."""
    blob = (TESTDATA / "MR_dev_alias.micw").read_bytes()
    p = mict_parse(st.micw_parse(blob)[7][0][0])
    with pytest.raises(NotImplementedError, match="> 12"):
        st._strip_bucket((128, 13, *p[2:]), (b"", 0, 0, 0, 0, st.STRIP_MODE_ZZ), "zz", 200,
                         16, False, 4095)


# ---------------------------------------------------------------------------
# (d) round trips through the port's encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pred", ["auto", "zz", "avg", "auto-fast"])
def test_port_round_trip_odd_width(ref, pred):
    """The 200 x 32 image of the port's encoder: bytes equal to
    micw_compress, and the port decodes what it wrote."""
    rng = np.random.default_rng(2)
    img = _smooth(rng, 32, 200, scale=25)
    img[rng.random((32, 200)) < 0.03] = 3900
    px = img.ravel()
    (blob,) = micw_compress_device_many([(px, 200, 32, int(px.max()))], CPU, predictor=pred)
    assert blob == ref.st.micw_compress(px, 200, 32, int(px.max()), predictor=pred)
    _decode_ok(blob, px)


def test_port_round_trip_auto_fixture():
    """MR_dev_auto re-encoded by the port (auto, standard) equals the
    fixture and decodes bit-exact."""
    px = np.fromfile(TESTDATA / "MR_dev_auto.raw", dtype="<u2")
    want = (TESTDATA / "MR_dev_auto.micw").read_bytes()
    mv = st.micw_parse(want)[4]
    (blob,) = micw_compress_device_many([(px, 256, 256, mv)], CPU, predictor="auto")
    assert blob == want
    _decode_ok(blob, px)


# ---------------------------------------------------------------------------
# The CUDA kernels and the post path on the card
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_batch():
    """Post-path containers the card test decodes, with their pixels: the
    avg fixture, CT re-encoded at tl 13 and at tl 15, and an odd-width
    CT crop."""
    px = _ct()
    mr = np.fromfile(TESTDATA / "MR_dev_auto.raw", dtype="<u2")
    return [((TESTDATA / "MR_dev_auto.micw").read_bytes(), mr),
            (REENCODED[13].read_bytes(), px), (REENCODED[15].read_bytes(), px)]


@pytest.mark.cuda
def test_cuda_post_kernels_match_plain():
    dev = _need_cuda()
    batch = _card_batch()
    plan = MicwDecodePlan([b for b, _px in batch] * 2, dev)
    seen = set()
    for b in plan.buckets.values():
        before = b.fn.launches
        got = b.fn(*b.ops, **b.kwargs)
        torch.cuda.synchronize()
        assert b.fn.launches == before + 1
        assert torch.equal(got, PLAIN[b.fn](*b.ops, **b.kwargs)), b.kwargs
        seen.add(b.fn)
    assert {rd.rans_decode_packed, rd.rans_decode} <= seen


@pytest.mark.cuda
def test_cuda_post_plan_matches_cpu_plan():
    dev = _need_cuda()
    batch = _card_batch()
    blobs = [b for b, _px in batch]
    gpu, cpu = MicwDecodePlan(blobs, dev), MicwDecodePlan(blobs, CPU)
    got, want = gpu.run(), cpu.run()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    assert gpu.verify_batch(got, [px for _b, px in batch]) == 0
