"""The port's device encode against mic_tpu, byte for byte.

* the encode tables (``magicu`` / ``build_enc_tables``) and every copied
  host function of the encode path, against their originals;
* the encode kernel's wrappers (plain versions on CPU tensors) against
  ``rans_encode_pallas`` / ``rans_encode_pallas_alias`` in interpret mode,
  on the same numpy operands, all three outputs, whole arrays;
* ``mict_encode_device_batch`` against the host encoder and mic_tpu's
  device batch encoder;
* ``micw_compress_device_many`` against ``micw_compress`` on small images
  and on the in-repo fixtures, and round trips through the port's
  decode;
* the FF 41 kernel's slot map (a numpy mirror of its build, a run at a
  time) against the 9-round search and ``alias_construct``'s
  ``slot_of``, and the per-stream ``widths`` operand.

Tolerance 0 everywhere: this is a lossless codec and the containers must
be byte-identical.  The ``cuda`` tests hold the kernel against its plain
version on the card (fixtures, mixed tableLogs, per-stream widths and
dishonest operands) and the card's blobs against the fixtures; they need
no jax, so on a machine with a GPU and no jax they run with
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_rans_encode.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as hs

from mic_tpu_torch import micw_compress_device, micw_compress_device_many, micw_decode_many
from mic_tpu_torch.tpu import device_rans as dr
from mic_tpu_torch.tpu import rans_encode as re_
from mic_tpu_torch.tpu import strips as st

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "web" / "testdata"
CPU = torch.device("cpu")

# name -> (container, pixels, predictor, entropy)
FIXTURES = {
    "CT_dev": (TESTDATA / "CT_dev.micw", TESTDATA / "CT_dev.raw", "auto-fast", "standard"),
    "CT_dev_alias": (ROOT / "tests" / "data" / "torch_port" / "CT_dev_alias.micw",
                     TESTDATA / "CT_dev.raw", "auto-fast", "alias"),
    "MR_dev": (TESTDATA / "MR_dev.micw", TESTDATA / "MR_dev.raw", "auto-fast", "standard"),
    "MR_dev_alias": (TESTDATA / "MR_dev_alias.micw", TESTDATA / "MR_dev_alias.raw",
                     "auto-fast", "alias"),
    "MR_dev_rbest": (TESTDATA / "MR_dev_rbest.micw", TESTDATA / "MR_dev_rbest.raw",
                     "auto-r", "best"),
    "MR_dev_auto": (TESTDATA / "MR_dev_auto.micw", TESTDATA / "MR_dev_auto.raw",
                    "auto", "standard"),
    "wide_banded": (TESTDATA / "wide_banded.micw", TESTDATA / "wide_banded.raw",
                    "auto-fast", "standard"),
}


def _fixture_image(name):
    """(blob, (pixels, width, height, max_value)) with the dimensions and
    max_value read from the fixture's own header."""
    blob_p, raw_p, _pred, _ent = FIXTURES[name]
    blob = blob_p.read_bytes()
    w, h, _ns, _sh, mv = st.micw_parse(blob)[:5]
    band = st.micw_band_info(blob)
    if band is not None:
        w, h = band
    return blob, (np.fromfile(raw_p, dtype="<u2"), w, h, mv)


@pytest.fixture(scope="module")
def ref():
    """mic_tpu's encoders, Pallas encode kernels and container code
    (needs jax)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from mic_tpu.tpu import device_rans, pallas_enc, strips

    return jnp, device_rans, pallas_enc, strips


def _smooth(rng, h, w, axis=1, scale=11, base=700):
    img = rng.standard_normal((h, w)).cumsum(axis=axis) * scale + base
    return img.clip(0, 4095).astype(np.uint16)


def _zz_stream(rng, h, w, spread):
    px = _smooth(rng, h, w, scale=spread, base=1000).ravel()
    return st._zzd_syms(px, w, h)


def _assert_same(a, b, where=""):
    """Deep equality of nested tuples / lists / dicts / arrays / scalars."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


# ---------------------------------------------------------------------------
# (a) encode tables and the copied host code
# ---------------------------------------------------------------------------


def test_magicu_matches_reference(ref):
    _jnp, _dr, pe, _st = ref
    rng = np.random.default_rng(1)
    divisors = list(range(2, 300)) + rng.integers(300, 1 << 15, 200).tolist() + [
        4095, 4096, 4097, 1 << 14, (1 << 15) - 1]
    adds = 0
    for d in divisors:
        got = re_.magicu(d)
        assert got == pe.magicu(d), d
        assert re_._verify_magic(d, *got), d
        adds += got[1]
    assert adds > 0, "no 33-bit (add == 1) magic among the divisors"


def test_build_enc_tables_matches_reference(ref):
    """An alphabet of 4000 ranks (asweep = 32) beside a small one, with
    freq-1 ranks and add == 1 magics among them."""
    _jnp, _dr, pe, _st = ref
    rng = np.random.default_rng(2)
    specs = []
    for a in (4000, 37):
        freqs = rng.integers(1, 12, a).astype(np.uint32)
        freqs[rng.random(a) < 0.3] = 1
        freqs[:3] = (7, 641, 2047)  # 33-bit magics (add == 1)
        cums = np.concatenate(([0], np.cumsum(freqs)[:-1])).astype(np.uint32) & 0xFFF
        specs.append((freqs, cums))
    got = re_.build_enc_tables(specs, 12)
    _assert_same(got, pe.build_enc_tables(specs, 12))
    te1, _te2, asweep = got
    assert asweep == 32
    assert ((te1 >> 16) & 1).any() and ((te1 >> 17) & 1).any()


def test_norm_header_and_alias_plan_match_reference(ref):
    _jnp, rdr, _pe, _st = ref
    rng = np.random.default_rng(3)
    for a, n in ((40, 5000), (300, 9000), (173, 9765)):
        data = rng.integers(0, a, n).astype(np.uint16)
        data[rng.random(n) < 0.5] = 0
        counts = np.bincount(data)
        sl = len(counts)
        _assert_same(dr._norm_and_header(counts, n, 11, sl),
                     rdr._norm_and_header(counts, n, 11, sl))
        for kept in (255, 100):
            plan = dr._alias_plan(counts, sl, kept)
            _assert_same(plan, rdr._alias_plan(counts, sl, kept))
            _assert_same(dr._alias_apply(data, plan[0], plan[3]),
                         rdr._alias_apply(data, plan[0], plan[3]))
        _assert_same(dr.alias_encode_plan(counts, sl, n, 12),
                     rdr.alias_encode_plan(counts, sl, n, 12))


def test_strip_helpers_match_reference(ref, monkeypatch):
    """Symbol transforms, escaped tokens, estimates, trial sets, candidate
    generation, requests (with and without MICW_R_MARGIN) and selection."""
    _jnp, _dr, _pe, rst = ref
    rng = np.random.default_rng(4)
    px = _smooth(rng, 16, 128)
    px[8:, :40] = 900  # a run for the RLE modes
    px = px.ravel()
    for mv in (255, 1023, 4095, 65535):
        assert st._rle_mid(mv) == rst._rle_mid(mv)
    for name in ("zzd", "vdd", "pdd", "zzr", "vdr", "pdr"):
        _assert_same(st._DIRECT_SYMS[name](px, 128, 16), rst._DIRECT_SYMS[name](px, 128, 16))
    for pred in ("zz", "avg"):
        _assert_same(st._escaped_tokens(px, 128, 16, 4095, pred),
                     rst._escaped_tokens(px, 128, 16, 4095, pred))
    wide = rng.integers(0, 6000, 8000).astype(np.uint16)
    for syms in (st._zzd_syms(px, 128, 16), wide):
        for alias in (False, True):
            assert st._estimate_bytes(syms, alias) == rst._estimate_bytes(syms, alias)
    for p in ("auto", "auto-r", "auto-fast", "zzd", "avg", "pdr"):
        assert st._trials_for(p) == rst._trials_for(p)
    with pytest.raises(ValueError):
        st._trials_for("nope")
    for margin in ("0", "0.05", "junk"):
        monkeypatch.setenv("MICW_R_MARGIN", margin)
        assert st._r_margin() == rst._r_margin()
        for pred in ("auto", "auto-r"):
            trials = st._trials_for(pred)
            for ent in ("standard", "alias", "best"):
                cands = st._strip_candidates(px, 128, 16, 4095, 1023, trials, ent)
                _assert_same(cands, rst._strip_candidates(px, 128, 16, 4095, 1023,
                                                          trials, ent))
                reqs = st._strip_requests(cands, len(trials), ent)
                assert reqs == rst._strip_requests(cands, len(trials), ent)

                def enc(i, alias, _c=cands):
                    return rst._encode_candidate(_c[i][1], 128, max_bytes=px.nbytes,
                                                 alias=alias, counts=_c[i][2])

                _assert_same(st._strip_select(cands, px, len(trials), ent, enc),
                             rst._strip_select(cands, px, len(trials), ent, enc))


# ---------------------------------------------------------------------------
# (b) the kernel's wrappers against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _kernel_streams(rng, alias):
    """Three streams of 4000, 2500 and 1000 symbols (32 steps, partial
    last steps) whose tableLogs differ, staged for one launch."""
    streams = [np.minimum(rng.geometric(p, n), 299).astype(np.uint16)
               for p, n in ((0.02, 4000), (0.15, 2500), (0.05, 1000))]
    staged = re_.stage_encode_batch(streams, alias=alias,
                                    max_table_log=12 if alias else 11)
    assert staged.steps == 32 and len(staged.metas) == 3
    assert len({m[1] for m in staged.metas}) > 1, "one tableLog for all streams"
    return staged


def _pallas_encode(ref, ops, steps, alias):
    jnp, _dr, pe, _st = ref
    asweep = ops[1].shape[1] // 128
    fn = pe.rans_encode_pallas_alias if alias else pe.rans_encode_pallas
    out = fn(*map(jnp.asarray, ops), steps=steps, n_strips=ops[0].shape[0], asweep=asweep)
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("alias", [False, True], ids=["ff57", "ff41"])
@pytest.mark.parametrize("dishonest", [False, True], ids=["ranks_ok", "ranks_beyond_table"])
def test_kernel_wrapper_matches_pallas(ref, alias, dishonest):
    rng = np.random.default_rng(5 + alias)
    staged = _kernel_streams(rng, alias)
    ops = list(staged.ops)
    if dishonest:  # active and pad lanes alike read zero table entries
        rk = ops[0].copy()
        rk.reshape(-1)[rng.integers(0, rk.size, 200)] = 0xFFFF
        ops[0] = rk
    want = _pallas_encode(ref, tuple(ops), staged.steps, alias)
    staged.ops = tuple(ops)
    fn = re_.rans_encode_alias if alias else re_.rans_encode
    before = fn.launches
    got = fn(*re_.staged_to_device(staged, CPU), steps=staged.steps)
    assert fn.launches == before  # the CPU takes the plain version
    w, f, x = (got[0].numpy().view(np.uint16), got[1].numpy().view(np.uint16),
               got[2].numpy().view(np.uint32))
    assert np.array_equal(w, want[0]) and np.array_equal(f, want[1])
    assert np.array_equal(x, want[2])
    assert f.any() and set(np.unique(f)) <= {0, 1}


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguity", "device", "width", "steps",
                                   "widths"])
def test_wrapper_rejects_bad_operands(fault):
    staged = re_.stage_encode_batch([_zz_stream(np.random.default_rng(6), 8, 128, 9)],
                                    alias=True)
    ops = list(re_.staged_to_device(staged, CPU))
    steps = staged.steps
    if fault == "dtype":
        ops[0] = ops[0].to(torch.int32)
    elif fault == "shape":
        ops[5] = ops[5][:, :64].contiguous()
    elif fault == "contiguity":
        ops[3] = ops[3].transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "device":
        ops[2] = ops[2].to("meta")
    elif fault == "width":
        ops[1] = torch.zeros((1, 4224), dtype=torch.int32)
        ops[2] = ops[1].clone()
    elif fault == "widths":  # one per strip
        with pytest.raises(ValueError):
            re_.rans_encode_alias(*ops, steps=steps, widths=torch.zeros(2, dtype=torch.int32))
        return
    else:
        steps += 1
    with pytest.raises((TypeError, ValueError)):
        re_.rans_encode_alias(*ops, steps=steps)


@pytest.mark.parametrize("alias", [False, True], ids=["ff57", "ff41"])
def test_widths_operand_reads_zero_past_each_strip(alias):
    """``widths``: the staged alphabets give the batch width's result (the
    tables are zero past them); cut widths (0, a few, past the table) give
    what the tables zeroed past them give without the operand."""
    staged = _kernel_streams(np.random.default_rng(12 + alias), alias)
    ops = re_.staged_to_device(staged, CPU)
    fn = re_.rans_encode_alias if alias else re_.rans_encode
    want = fn(*ops, steps=staged.steps)
    got = fn(*ops, steps=staged.steps, widths=torch.from_numpy(staged.widths))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    aw = ops[1].shape[1]
    cut = torch.tensor([0, 9, aw + 5], dtype=torch.int32)
    te1, te2 = ops[1].clone(), ops[2].clone()
    past = torch.arange(aw)[None, :] >= cut.clamp(max=aw)[:, None]
    te1[past], te2[past] = 0, 0
    want = fn(ops[0], te1, te2, *ops[3:], steps=staged.steps)
    got = fn(*ops, steps=staged.steps, widths=cut)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(got[2], fn(*ops, steps=staged.steps)[2])


# ---------------------------------------------------------------------------
# The FF 41 kernel's slot map (csrc/rans_encode.cu), mirrored in numpy
# ---------------------------------------------------------------------------


def _search(starts, bases, s_idx):
    """The plain twin's slot rule (``rans_encode._encode_plain``): r the
    count of starts <= s_idx by a 9-round binary search, less one (at
    least 0); base[r] + (s_idx - start[r]) mod 2^32."""
    starts, bases = starts.astype(np.int64), bases.astype(np.int64)
    n_le = np.zeros(s_idx.shape, np.int64)
    step = 256
    while step:
        cand = n_le + step
        v = starts[np.minimum(cand - 1, 255)]
        n_le = np.where((cand <= 256) & (v <= s_idx), cand, n_le)
        step >>= 1
    r = np.maximum(n_le - 1, 0)
    return (bases[r] + s_idx - starts[r]) & 0xFFFFFFFF


def _slot_map(starts, bases, tl):
    """The kernel's map build, a run at a time in its order: run r writes
    base[r] + (s - start[r]) at slots [start[r], start[r+1]) (run 0 from
    slot 0) below 2^min(tl, 12).  Returns (map, usable): not usable, the
    kernel searches every step (starts not sorted, or a value past 16
    bits)."""
    msize = 1 << min(tl, 12)
    smap = np.zeros(msize, np.uint16)
    st = starts.astype(np.int64)
    delta = (bases.astype(np.int64) - st) & 0xFFFFFFFF
    usable = True
    for r in range(256):
        nx = st[r + 1] if r + 1 < 256 else 0xFFFFFFFF
        usable &= bool(nx >= st[r])
        i = np.arange(st[r] if r else 0, min(nx, msize))
        v = (delta[r] + i) & 0xFFFFFFFF
        usable &= bool((v <= 0xFFFF).all())
        smap[i] = v
    return smap, usable


def _run_tables(al):
    """``alias_construct``'s encoder runs as the kernel's 256-entry
    operands (pad 0xFFFFFFFF and 0)."""
    starts, bases = al["enc_runs"]
    ar1 = np.full(256, 0xFFFFFFFF, np.uint32)
    ar2 = np.zeros(256, np.uint32)
    ar1[: len(starts)], ar2[: len(bases)] = starts, bases
    return ar1, ar2


def _assert_map_is_the_search(ar1, ar2, tl, slot_of=None):
    smap, usable = _slot_map(ar1, ar2, tl)
    assert usable
    s = np.arange(1 << min(tl, 12))
    assert np.array_equal(smap, _search(ar1, ar2, s))
    if slot_of is not None:
        assert np.array_equal(smap, slot_of)


@pytest.mark.parametrize("name", ["CT_dev_alias", "MR_dev_alias"])
def test_slot_map_of_fixture_streams(name):
    """Every FF 41 candidate stream of a fixture: the map equals the
    search and ``alias_construct``'s ``slot_of`` on every slot."""
    from mic_tpu_torch.ops.fse import DEFAULT_TABLE_LOG, IncompressibleError, histogram

    _blob, image = _fixture_image(name)
    plan = re_.MicwEncodePlan([image], "alias", "auto-fast")
    checked = 0
    for syms, _budget in plan.jobs[True]:
        counts, _mx, symbol_len = histogram(np.asarray(syms, np.uint16))
        try:
            plan_ = dr.alias_encode_plan(counts, symbol_len, len(syms), DEFAULT_TABLE_LOG,
                                         st.ALIAS_TABLE_LOG)
        except IncompressibleError:  # the stream is not encoded
            continue
        tl, al = plan_[2], plan_[6]
        _assert_map_is_the_search(*_run_tables(al), tl, al["slot_of"])
        checked += 1
    assert checked >= 4


@settings(max_examples=40, deadline=None, database=None)
@given(seed=hs.integers(0, 2**32 - 1), n_syms=hs.integers(2, 300),
       skew=hs.floats(0.2, 3.0), tl=hs.integers(7, 12))
def test_slot_map_of_made_streams(seed, n_syms, skew, tl):
    """Histograms made from a seed (alphabets of 2-300 symbols, skewed or
    flat, tableLogs 7-12): where the alias layout exists the map equals
    the search and ``slot_of``."""
    from mic_tpu_torch.ops.fse import IncompressibleError

    rng = np.random.default_rng(seed)
    counts = np.zeros(n_syms + 5, np.int64)
    counts[rng.choice(n_syms + 5, n_syms, replace=False)] = (
        1 + (rng.pareto(skew, n_syms) * 50).astype(np.int64).clip(0, 10**6))
    n = int(counts.sum())
    assume(counts.max() < n)
    try:
        plan = dr.alias_encode_plan(counts, len(counts), n, tl, tl)
    except IncompressibleError:  # no alias layout: no stream
        assume(False)
    _assert_map_is_the_search(*_run_tables(plan[6]), plan[2], plan[6]["slot_of"])


@pytest.mark.parametrize("case", ["first_start_past_0", "equal_starts", "256_runs",
                                  "unsorted", "bases_past_16_bits"])
def test_slot_map_of_made_tables(case):
    """Hand-made run tables: a first start past slot 0 (slots below it
    take run 0, as the search's), runs of equal starts (the last of them),
    exactly 256 runs (no pad); unsorted starts and a map value past 16 bits
    leave the map unusable, and the kernel searches every step."""
    rng = np.random.default_rng(13)
    tl = 12
    starts = np.sort(rng.choice(4096, 256, replace=False)).astype(np.uint32)
    bases = rng.integers(0, 4096 - 16, 256).astype(np.uint32)
    if case == "first_start_past_0":  # slots 0-36 take run 0: base[0] + s - 37
        starts[:100] = np.sort(rng.choice(np.arange(38, 4096), 100, replace=False))
        starts[0], starts[100:], bases[0] = 37, 0xFFFFFFFF, 100
    elif case == "equal_starts":
        starts[10:14] = starts[10]
        starts[200:] = 0xFFFFFFFF
    elif case == "256_runs":
        starts[0] = 0
    elif case == "unsorted":
        starts[10:60] = starts[10:60][::-1]
    else:
        bases[7] = 0x10000 - 2
    if case in ("unsorted", "bases_past_16_bits"):  # the map would be wrong: unusable
        smap, usable = _slot_map(starts, bases, tl)
        assert not usable and not np.array_equal(smap, _search(starts, bases, np.arange(4096)))
        return
    _assert_map_is_the_search(starts, bases, tl)
    _assert_map_is_the_search(starts, bases, 9)  # a map of 512 slots: the same rule


# ---------------------------------------------------------------------------
# (c) MICT blobs: mict_encode_device_batch
# ---------------------------------------------------------------------------


def test_device_batch_standard_matches_host_and_jax(ref):
    """Mixed tableLogs and the magic-division path in one launch (the
    streams of test_tpu_tier's and test_device_compiled's encode tests)."""
    _jnp, rdr, pe, _st = ref
    rng = np.random.default_rng(8)
    streams = [_zz_stream(rng, 24, 128, 8), _zz_stream(rng, 16, 128, 30),
               _zz_stream(rng, 64, 128, 40)]
    for mtl in (11, 12):
        host = [rdr.mict_encode(s, lanes=128, max_table_log=mtl) for s in streams]
        got = re_.mict_encode_device_batch(streams, CPU, max_table_log=mtl)
        assert got == host, mtl
    assert got == pe.mict_encode_device_batch(streams, max_table_log=12)


def test_device_batch_alias_matches_host_and_jax(ref, monkeypatch):
    """FF 41 streams: small alphabets, an escape-folded one (alphabet over
    255), alphabets of 60 and 300 (test_alias_kernel /
    test_device_compiled), and one whose first alias layout is infeasible
    (the kept-reduction retry)."""
    _jnp, rdr, pe, _st = ref
    rng = np.random.default_rng(9)
    streams = []
    for n, alpha, esc in ((5000, 40, 0), (3000, 12, 0), (6000, 30, 0.1)):
        base = np.minimum(rng.geometric(0.08, n), alpha - 1).astype(np.uint16)
        if esc:
            tail = rng.integers(0, 30000, n).astype(np.uint16)
            base = np.where(rng.random(n) < esc, tail, base)
        streams.append(base)
    for n, alpha in ((4096, 60), (6000, 300)):
        streams.append(np.minimum(rng.geometric(2.0 / alpha, n), alpha).astype(np.uint16))
    retry = rng.integers(0, 173, 9765).astype(np.uint16)
    retry[rng.random(9765) < 0.5] = 0
    streams.append(retry)

    outcomes = []
    real = dr.alias_construct

    def spy(norm, tl):
        try:
            out = real(norm, tl)
        except dr.AliasInfeasible:
            outcomes.append("infeasible")
            raise
        outcomes.append("ok")
        return out

    monkeypatch.setattr(dr, "alias_construct", spy)
    host = [rdr.mict_encode_alias(s, table_log=12) for s in streams]
    got = re_.mict_encode_device_batch(streams, CPU, alias=True)
    assert got == host
    assert "infeasible" in outcomes, "no stream took the kept-reduction retry"
    assert len(dr.mict_parse(got[2])[7][1]) > 0, "no escapes triggered"
    for blob, s in zip(got, streams):
        assert np.array_equal(rdr.mict_decode_numpy(blob), s)
    assert got == pe.mict_encode_device_batch(streams, alias=True)


@pytest.mark.parametrize("alias", [False, True], ids=["ff57", "ff41"])
def test_device_batch_failures_and_budgets(ref, alias):
    """Sentinel errors per stream: on_error="none" leaves None at an
    empty, a constant (UseRLE), an all-distinct (Incompressible) and an
    over-budget stream and encodes the rest; on_error="raise" raises the
    host encoder's error.  None budgets take the raw-size default."""
    _jnp, rdr, pe, _st = ref
    from mic_tpu_torch.ops.fse import IncompressibleError, UseRLEError

    rng = np.random.default_rng(10)
    good = [_zz_stream(rng, 8, 128, 9), _zz_stream(rng, 12, 128, 20)]
    streams = [good[0], np.zeros(0, np.uint16), np.full(3000, 7, np.uint16),
               np.arange(2000, dtype=np.uint16), good[1], good[1]]
    mtl = 12 if alias else 11
    host0 = rdr.mict_encode(good[0], lanes=128, max_table_log=mtl, alias=alias)
    budgets = [None, None, None, None, len(host0) + 10**6, 100]
    got = re_.mict_encode_device_batch(streams, CPU, on_error="none", alias=alias,
                                       max_table_log=mtl, max_bytes=budgets)
    want = pe.mict_encode_device_batch(streams, on_error="none", alias=alias,
                                       max_table_log=mtl, max_bytes=budgets)
    assert got == want
    assert got[0] == host0
    assert got[4] == rdr.mict_encode(good[1], lanes=128, max_table_log=mtl,
                                     max_bytes=budgets[4], alias=alias)
    assert got[1:4] == [None] * 3 and got[5] is None
    with pytest.raises(UseRLEError):
        re_.mict_encode_device_batch(streams[2:3], CPU, alias=alias)
    for bad in (streams[3:4], streams[5:6]):
        with pytest.raises(IncompressibleError):
            re_.mict_encode_device_batch(bad, CPU, alias=alias, max_bytes=budgets[5:6])
    assert re_.mict_encode_device_batch(streams[1:3], CPU, on_error="none",
                                        alias=alias) == [None, None]


def test_device_batch_rejects_wide_alphabets():
    """Standard streams whose alphabet exceeds the kernel's 4096 ranks
    (tableLog 13 admits them) fail like any sentinel error."""
    from mic_tpu_torch.ops.fse import IncompressibleError

    syms = np.random.default_rng(11).integers(0, 5000, 65536).astype(np.uint16)
    assert len(np.unique(syms)) > 4096
    assert re_.mict_encode_device_batch([syms], CPU, max_table_log=13,
                                        on_error="none") == [None]
    with pytest.raises(IncompressibleError):
        re_.mict_encode_device_batch([syms], CPU, max_table_log=13)


# ---------------------------------------------------------------------------
# (d) MICW containers against micw_compress
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def images():
    """The four 32x128 images of tests/test_device_encode_rmodes.py:
    smooth, runs, spikes, and one with a constant strip."""
    rng = np.random.default_rng(7)
    a = (rng.standard_normal((32, 128)).cumsum(1) * 11 + 700).clip(0, 4095).astype(np.uint16)
    b = (rng.standard_normal((32, 128)).cumsum(0) * 9 + 600).astype(np.int32)
    b = np.where(b > 610, b, 0).clip(0, 4095).astype(np.uint16)
    c = a.copy()
    m = rng.random((32, 128)) < 0.02
    c[m] = rng.integers(0, 4095, int(m.sum())).astype(np.uint16)
    d = np.full((32, 128), 777, np.uint16)
    d[:16] = b[:16]
    return [(x.ravel(), 128, 32, int(x.max()), 2) for x in (a, b, c, d)]


@pytest.mark.parametrize("pred", ["auto-r", "auto-fast", "auto", "zzd"])
@pytest.mark.parametrize("ent", ["standard", "alias", "best"])
def test_device_many_byte_identity(ref, images, pred, ent):
    _jnp, _dr, _pe, rst = ref
    host = [rst.micw_compress(px, w, h, mx, num_strips=ns, predictor=pred, entropy=ent)
            for px, w, h, mx, ns in images]
    assert micw_compress_device_many(images, CPU, entropy=ent, predictor=pred) == host


def test_device_many_margin_identity(ref, images, monkeypatch):
    _jnp, _dr, _pe, rst = ref
    monkeypatch.setenv("MICW_R_MARGIN", "0.05")
    host = [rst.micw_compress(px, w, h, mx, num_strips=ns, predictor="auto-r",
                              entropy="best")
            for px, w, h, mx, ns in images]
    assert micw_compress_device_many(images, CPU, entropy="best", predictor="auto-r") == host


def test_device_many_banded_auto_r(ref):
    _jnp, _dr, _pe, rst = ref
    rng = np.random.default_rng(7)
    px = (rng.standard_normal((64, 1024)).cumsum(1) * 7 + 900).clip(0, 4095)
    px = px.astype(np.uint16).ravel()
    host = rst.micw_compress(px, 1024, 64, int(px.max()), predictor="auto-r", entropy="best")
    dev = micw_compress_device_many([(px, 1024, 64, int(px.max()))], CPU,
                                    entropy="best", predictor="auto-r")
    assert dev == [host]


def test_compress_device_single_image(ref):
    """micw_compress_device's defaults (predictor zzd, 128-row strips) on a
    wide-alphabet image, and the constant-strip path."""
    _jnp, _dr, _pe, rst = ref
    rng = np.random.default_rng(12)
    px = (rng.standard_normal((256, 512)).cumsum(axis=1) * 80 + 2000)
    px = px.clip(0, 4095).astype(np.uint16)
    px[128:] = 500
    px = px.ravel()
    for ent in ("standard", "alias"):
        host = rst.micw_compress(px, 512, 256, int(px.max()), predictor="zzd", entropy=ent)
        assert micw_compress_device(px, 512, 256, int(px.max()), CPU, entropy=ent) == host
    modes = [s[5] for s in st.micw_parse(host)[7]]
    assert modes == [st.STRIP_MODE_ZZD, st.STRIP_MODE_CONST]
    with pytest.raises(ValueError):
        micw_compress_device(px, 512, 256, 4095, CPU, entropy="huffman")
    with pytest.raises(ValueError):
        micw_compress_device(px[:-1], 512, 256, 4095, CPU)


# ---------------------------------------------------------------------------
# (e) full-size fixtures, and round trips through the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_byte_identity(ref, name):
    """The fixture is still what micw_compress writes (a stale fixture
    fails here first), and the port writes the same bytes."""
    _jnp, _dr, _pe, rst = ref
    blob, image = _fixture_image(name)
    _b, _r, pred, ent = FIXTURES[name]
    assert rst.micw_compress(*image, predictor=pred, entropy=ent) == blob
    assert micw_compress_device_many([image], CPU, entropy=ent, predictor=pred) == [blob]


@pytest.mark.parametrize("ent", ["standard", "alias"])
def test_round_trip_through_port(ent):
    """CT_dev and MR_dev encoded by the port (auto-fast) decode through
    the port's micw_decode_many bit-exact."""
    imgs = [_fixture_image(n)[1] for n in ("CT_dev", "MR_dev")]
    blobs = micw_compress_device_many(imgs, CPU, entropy=ent, predictor="auto-fast")
    for (px, w, h, _mv), (out, ow, oh) in zip(imgs, micw_decode_many(blobs, CPU)):
        assert (ow, oh) == (w, h)
        assert out.dtype == np.uint16 and np.array_equal(out, px)


def test_plan_launches_one_batch_per_family(monkeypatch):
    """Every requested candidate of every strip of every image goes
    through at most one encode batch per entropy family."""
    calls = []
    real = re_.mict_encode_device_batch

    def spy(streams, device, **kw):
        calls.append((kw["alias"], len(streams)))
        return real(streams, device, **kw)

    monkeypatch.setattr(re_, "mict_encode_device_batch", spy)
    imgs = [_fixture_image(n)[1] for n in ("MR_dev", "MR_dev_alias")]
    plan = re_.MicwEncodePlan(imgs, entropy="best", predictor="auto-fast")
    plan.assemble(plan.encode(CPU))
    assert sorted(a for a, _n in calls) == [False, True]
    assert {a: n for a, n in calls} == {a: len(j) for a, j in plan.jobs.items()}


# ---------------------------------------------------------------------------
# On the card (skipped elsewhere)
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_case(staged, alias, dev, case):
    """The staged operands on ``dev`` and the wrapper's keyword arguments
    under ``case``: as staged (the batch width), with the per-stream
    widths, or dishonest (ranks 0xFFFF with widths halved on every other
    strip; every lane at tl 13 or 31, past the FF 41 map; FF 41 starts
    unsorted, or bases that put map values past 16 bits, on every other
    strip)."""
    rng = np.random.default_rng(14)
    ops = list(re_.staged_to_device(staged, dev))
    kw = {"steps": staged.steps}
    S = ops[0].shape[0]
    if case == "widths":
        kw["widths"] = torch.from_numpy(staged.widths).to(dev)
    elif case == "ranks_beyond_table":
        rk = ops[0].clone().view(-1)
        rk[torch.from_numpy(rng.integers(0, rk.numel(), 200)).to(dev)] = -1
        ops[0] = rk.view_as(ops[0])
        half = staged.widths.copy()
        half[::2] //= 2
        kw["widths"] = torch.from_numpy(half).to(dev)
    elif case in ("tls13", "tls31"):
        ops[-1] = torch.full_like(ops[-1], int(case[3:]))
    elif case == "unsorted_ar1" and alias:
        ar1 = ops[3].clone().view(S, 256)
        ar1[::2, 10:60] = ar1[::2, 10:60].flip(1)
        ops[3] = ar1.view(S, 2, 128)
    elif case == "bases_past_16_bits" and alias:
        ar2 = ops[4].clone()
        ar2[::2] += 0x10000
        ops[4] = ar2
    return ops, kw


CARD_CASES = ["staged", "widths", "ranks_beyond_table", "tls13", "tls31", "unsorted_ar1",
              "bases_past_16_bits"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
@pytest.mark.parametrize("name", ["CT_dev", "CT_dev_alias", "MR_dev_rbest", "mixed_tl"])
def test_cuda_kernel_matches_plain(name, case):
    """Both forms of the encode kernel against their plain twins on the
    card, all three outputs: each fixture's candidate streams (one launch
    a family) and three made streams of three tableLogs in one launch,
    as staged, with per-stream widths and under dishonest operands."""
    dev = _need_cuda()
    if name == "mixed_tl":
        batches = {a: _kernel_streams(np.random.default_rng(5 + a), a) for a in (False, True)}
    else:
        _blob, image = _fixture_image(name)
        _b, _r, pred, ent = FIXTURES[name]
        plan = re_.MicwEncodePlan([image], ent, pred)
        batches = {alias: re_.stage_encode_batch(
            [j[0] for j in jobs], on_error="none", alias=alias,
            max_table_log=st.ALIAS_TABLE_LOG if alias else st.MAX_TABLE_LOG)
            for alias, jobs in plan.jobs.items() if jobs}
    for alias, staged in batches.items():
        ops, kw = _card_case(staged, alias, dev, case)
        fn = re_.rans_encode_alias if alias else re_.rans_encode
        plain = re_.rans_encode_alias_plain if alias else re_.rans_encode_plain
        before = fn.launches
        got = fn(*ops, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        want = plain(*ops, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (name, case, alias)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_cuda_blobs_match_fixtures(name):
    dev = _need_cuda()
    blob, image = _fixture_image(name)
    _b, _r, pred, ent = FIXTURES[name]
    assert micw_compress_device_many([image, image], dev, entropy=ent,
                                     predictor=pred) == [blob, blob]
