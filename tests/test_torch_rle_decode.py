"""The port's r-mode decode (zzr / vdr / pdr) against mic_tpu.

* the copied sizing helpers (``_runs_floor``, ``_pow2_at_least``, the
  run-table capacity, entropy steps and output rows of a bucket) against
  the sizes ``mic_tpu``'s staging gives its fused r-kernel;
* both r-kernel wrappers (plain versions on CPU tensors) against
  ``rans_decode_pallas_rle`` / ``rans_decode_pallas_rle_alias`` in
  interpret mode, on the operands of the port's own buckets, whole output
  arrays (the rows past a strip's pixels included), over the run
  grammars of ``tests/test_rle_fused.py``;
* ``MicwDecodePlan`` on the tissue fixtures, with and without
  FLAG_RDENSE, against the ``.raw`` planes and ``micw_decompress_host``;
* the fixtures against ``micw_compress``, the round trip through the
  port's device encoder, the strips still outside the slice, and
  dishonest streams through the plain versions.

Tolerance 0 everywhere: a lossless codec.

The fixtures ``tests/data/torch_port/tissue_*.micw`` were written by
``mic_tpu.tpu.strips.micw_compress`` from the planes of
``web/testdata/tissue_dev.raw`` (a 512x384 WSI tile, interleaved u8 RGB)::

    px = np.fromfile("web/testdata/tissue_dev.raw", "u1").reshape(384, 512, 3)
    plane = px[:, :, c].astype(np.uint16).ravel()     # c = 0, 1, 2 for r, g, b
    micw_compress(plane, 512, 384, 255, predictor=..., entropy=...)

with the default strips (3 x 128 rows) and the settings of ``FIXTURES``.
The ``cuda`` tests hold each CUDA kernel against its plain version on the
card and decode the fixtures there; they need no jax, so on a machine
with a GPU and no jax they run with
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_rle_decode.py``.
"""

import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from mic_tpu_torch import MicwDecodePlan, micw_compress_device_many, micw_decode_many
from mic_tpu_torch.tpu import rans_decode as rd
from mic_tpu_torch.tpu import strips as st
from mic_tpu_torch.tpu.device_rans import mict_parse

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "web" / "testdata"
PORT_DATA = ROOT / "tests" / "data" / "torch_port"
CPU = torch.device("cpu")

# name -> (plane, predictor, entropy)
FIXTURES = {
    **{f"tissue_{c}_rstd": (c, "auto-r", "standard") for c in "rgb"},
    **{f"tissue_{c}_rbest": (c, "auto-r", "best") for c in "rgb"},
    "tissue_g_pdr": ("g", "pdr", "standard"),
    "tissue_g_zzr_alias": ("g", "zzr", "alias"),
}
STRIPPED = ("tissue_g_pdr", "tissue_g_zzr_alias")  # decoded also with FLAG_RDENSE cleared
PLAIN = {rd.rans_decode_rle: rd.rans_decode_rle_plain,
         rd.rans_decode_rle_alias: rd.rans_decode_rle_alias_plain}


def _plane(c):
    px = np.fromfile(TESTDATA / "tissue_dev.raw", "u1").reshape(384, 512, 3)
    return px[:, :, "rgb".index(c)].astype(np.uint16).ravel()


def _strip_flag(blob):
    b = bytearray(blob)
    b[22] &= ~st.FLAG_RDENSE
    return bytes(b)


def _fixture(name, stripped=False):
    """(blob, expected pixels) of a fixture, optionally flag-stripped."""
    blob = (PORT_DATA / f"{name}.micw").read_bytes()
    return (_strip_flag(blob) if stripped else blob), _plane(FIXTURES[name][0])


def _batch():
    """The eight fixtures and the two flag-stripped copies."""
    cases = [(n, False) for n in FIXTURES] + [(n, True) for n in STRIPPED]
    return [_fixture(n, s) for n, s in cases]


@pytest.fixture(scope="module")
def ref():
    """mic_tpu's strips module and Pallas kernels (needs jax)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from mic_tpu.tpu import pallas_rans, strips

    return jnp, pallas_rans, strips


# ---------------------------------------------------------------------------
# (a) the copied sizing against mic_tpu's staging
# ---------------------------------------------------------------------------


def _bucket_entries(blobs):
    """{bucket key: [(parsed MICT, table entry)]} of the r-mode strips of
    ``blobs``, keyed by the port's ``_strip_bucket``."""
    entries = {}
    for blob in blobs:
        width, _h, _n, strip_h, _mv, gpred, _lanes, strips = st.micw_parse(blob)
        for s in strips:
            pred = st.strip_predictor(gpred, s[5])
            if pred in ("zzr", "vdr", "pdr"):
                p = mict_parse(s[0])
                key = st._strip_bucket(p, s, pred, width, strip_h,
                                       bool(blob[22] & st.FLAG_RDENSE))
                entries.setdefault(key, []).append((p, s))
    return entries


def _staged_sizes(ref_st, key, entries):
    """steps, out_rows, maxr, vdd_ws and dense of the fused r-kernel launch
    mic_tpu stages for ``entries``, read from the staging closure (which
    also pins that mic_tpu takes its fused r-kernel path for them)."""
    pred, width, strip_h = key[0].lstrip("a"), key[2], key[3]
    run = ref_st._stage_mict_group([e[0] for e in entries], [e[1] for e in entries], pred,
                                   width, strip_h, st.MID_DIRECT, 0, dense=key[4])
    assert run.__name__ in ("run_rle_fused", "run_alias_rle"), run.__name__
    v = dict(zip(run.__code__.co_freevars, (c.cell_contents for c in run.__closure__)))
    maxr = next(v[k] for k in ("maxr1", "maxr_f", "maxr_af") if k in v)
    return v["steps"], v["out_rows"], maxr, v["vws"], v["dense"]


def test_pow2_and_runs_floor_match_reference(ref):
    ref_st = ref[2]
    for x in (0, 1, 2, 3, 7, 8, 9, 100, 4096, 4097):
        for lo in (1, 8):
            assert st._pow2_at_least(x, lo) == ref_st._pow2_at_least(x, lo)
    for pred in ("zzd", "vdd", "pdd", "zzr", "vdr", "pdr", "zz", "avg"):
        for w, h in ((128, 16), (512, 128), (512, 512), (256, 40), (1024, 8)):
            assert st._runs_floor(pred, w, h) == ref_st._runs_floor(pred, w, h)


def test_rle_sizing_matches_reference(ref, monkeypatch):
    """The port's bucket sizes against mic_tpu's for the fixtures (40
    replicas of tissue_r_rstd take mic_tpu's path for groups of more than
    32 strips) and the grammars below."""
    ref_st = ref[2]
    blob_sets = [[b for b, _px in _batch()], [_fixture("tissue_r_rstd")[0]] * 40]
    blob_sets += [[_grammar_blob(ref_st, monkeypatch, n)[0]] for n in GRAMMARS]
    checked = 0
    for blobs in blob_sets:
        plan = MicwDecodePlan(blobs, CPU)
        for key, entries in _bucket_entries(blobs).items():
            kw = plan.buckets[key].kwargs
            assert _staged_sizes(ref_st, key, entries) == (
                kw["steps"], kw["out_rows"], kw["maxr"], kw["vdd_ws"], kw["dense"]), key
            checked += 1
    assert checked >= 20


# ---------------------------------------------------------------------------
# (b) both wrappers against the Pallas r-kernels
# ---------------------------------------------------------------------------


def _stripe(w=256, h=32):
    """Worst-case FLAG_RDENSE density in symbol space: 17-px steps of +1,
    whose zz symbols are one literal and a 16-long same-run each (~15 runs
    per 128-px row).  (The 16 + 1 px stripe of tests/test_rle_fused.py
    gives 15-long zero runs, so its dense stream is one literal run.)"""
    vals, v = [], 100
    while len(vals) < w:
        vals += [v] * 17
        v += 1
    return np.tile(np.array(vals[:w], np.uint16), h)


def _random_grammar(seed, h=64, w=128):
    """Seeded random runs (geometric lengths) and literal stretches of
    small steps around a random walk: compressible, unlike pure noise."""
    rng = np.random.default_rng(seed)
    vals, v = [], 600
    while sum(len(x) for x in vals) < h * w:
        v = int(np.clip(v + rng.integers(-40, 41), 0, 1200))
        if rng.random() < 0.6:
            vals.append(np.full(int(rng.geometric(0.04)), v, np.uint16))
        else:
            vals.append((v + rng.integers(-3, 4, int(rng.geometric(0.2)))).astype(np.uint16))
    return np.concatenate(vals)[: h * w]


def _giant():
    img = np.full((144, 128), 777, np.uint16)  # 18432 px > MID_DIRECT
    img[0, :] = np.arange(128, dtype=np.uint16) * 3 + 1
    img[-1, 64:] = 12345
    return img.ravel()


def _minimal_runs():
    """4-px steps: zz symbols alternate one literal and a 3-long zero
    same-run, 64 runs per 128-px row in the legacy grammar."""
    row = np.repeat((np.arange(32, dtype=np.uint16) % 7) * 11 + 1, 4)
    return np.tile(row, 16)


def _short_last():
    rng = np.random.default_rng(5)
    img = np.zeros((80, 128), np.uint16)
    img[:, :96] = 42
    img[:, 96:] = rng.integers(40, 44, (80, 32)).astype(np.uint16)
    return img.ravel()


def _vdr_wide():
    rng = np.random.default_rng(7)
    img = np.zeros((32, 256), np.uint16)
    img[:, :160] = 1000
    img[:, 160:224] = rng.integers(995, 1005, (32, 64)).astype(np.uint16)
    return img.ravel()


# name -> (pixels, width, height, num_strips, predictor, entropy, grammar);
# grammar "dense" is today's encoder, "legacy" the pre-FLAG_RDENSE one
# (same-runs of >= 3 px, flag clear), "stripped" today's runs with the
# flag cleared (the 256-run search on a dense stream).
GRAMMARS = {
    "giant_runs": (_giant, 128, 144, 1, "zzr", "standard", "dense"),
    "minimal_runs_legacy": (_minimal_runs, 128, 16, 1, "zzr", "alias", "legacy"),
    "short_last_strip": (_short_last, 128, 80, 3, "pdr", "alias", "dense"),
    "vdr_width_256": (_vdr_wide, 256, 32, 1, "vdr", "standard", "dense"),
    "random_zzr_standard": (lambda: _random_grammar(21), 128, 64, 2, "zzr", "standard",
                            "dense"),
    "random_vdr_alias": (lambda: _random_grammar(22), 128, 64, 2, "vdr", "alias", "dense"),
    "random_pdr_legacy": (lambda: _random_grammar(23), 128, 64, 2, "pdr", "standard",
                          "legacy"),
    "stripe_dense": (_stripe, 256, 32, 1, "zzr", "standard", "dense"),
    "stripe_stripped": (_stripe, 256, 32, 1, "zzr", "alias", "stripped"),
}


def _grammar_blob(ref_st, monkeypatch, name):
    make, w, h, ns, pred, ent, grammar = GRAMMARS[name]
    px = make()
    if grammar == "legacy":
        monkeypatch.setattr(ref_st, "RDENSE_MIN_SAME", 3)
    blob = ref_st.micw_compress(px, w, h, int(px.max()), num_strips=ns, predictor=pred,
                                entropy=ent)
    monkeypatch.undo()
    modes = {s[5] for s in ref_st.micw_parse(blob)[7]}
    assert modes == {st._PRED_MODE[pred]}, modes
    return (blob if grammar == "dense" else _strip_flag(blob)), px


def _pallas(ref, b):
    """rans_decode_pallas_rle[_alias] on bucket ``b``'s operands."""
    jnp, pr, _st = ref
    ops = [jnp.asarray(o.numpy().view(np.uint32)) for o in b.ops]
    kw = dict(b.kwargs, n_strips=b.n, mid_count=st.MID_DIRECT)
    if b.fn is rd.rans_decode_rle:
        tl = ops[1].shape[1].bit_length() - 1
        return np.asarray(pr.rans_decode_pallas_rle(*ops, table_log=tl,
                                                    asweep=ops[2].shape[1] // 128, **kw))
    return np.asarray(pr.rans_decode_pallas_rle_alias(*ops, **kw))


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_wrappers_match_pallas(ref, monkeypatch, name):
    blob, px = _grammar_blob(ref[2], monkeypatch, name)
    plan = MicwDecodePlan([blob], CPU)
    grammar, ent = GRAMMARS[name][6], GRAMMARS[name][5]
    rle = [b for b in plan.buckets.values() if b.fn in PLAIN]
    assert rle and all(b.kwargs["dense"] == (grammar == "dense") for b in rle)
    assert all((b.fn is rd.rans_decode_rle_alias) == (ent == "alias") for b in rle)
    for b in rle:
        got = b.fn(*b.ops, **b.kwargs).numpy().view(np.uint16)
        assert np.array_equal(got, _pallas(ref, b)), b.kwargs
    ((out, _w, _h),) = plan.assemble(plan.run())
    assert np.array_equal(out, px)
    if name == "short_last_strip":
        width, height, _n, strip_h = plan.metas[0]
        assert height % strip_h, "the last strip must be short"


def test_legacy_grammar_is_not_dense(ref, monkeypatch):
    """The legacy fixtures really need the 256-run window: a row spans
    more than 32 runs (so the Pallas and the port's dense windows would
    both miss runs)."""
    blob, _px = _grammar_blob(ref[2], monkeypatch, "minimal_runs_legacy")
    strip = st.micw_parse(blob)[7][0]
    assert strip[3] / (strip[2] / 128) > 32  # runs per 128-px row


# ---------------------------------------------------------------------------
# (c) the plan on the fixtures, (d) the fixtures themselves, (e) round trip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,stripped", [(n, False) for n in FIXTURES]
                         + [(n, True) for n in STRIPPED])
def test_fixture_decode_matches_raw_and_host(ref, name, stripped):
    blob, px = _fixture(name, stripped)
    modes = {s[5] for s in st.micw_parse(blob)[7]}
    assert modes <= {st.STRIP_MODE_ZZR, st.STRIP_MODE_VDR, st.STRIP_MODE_PDR}
    ((out, w, h),) = micw_decode_many([blob], CPU)
    assert (w, h) == (512, 384) and out.dtype == np.uint16
    assert np.array_equal(out, px)
    host, hw, hh = ref[2].micw_decompress_host(blob)
    assert (hw, hh) == (512, 384) and np.array_equal(out, np.asarray(host).ravel())


def test_fixture_batch_buckets():
    """One plan over all ten: every (mode x family) pair and both grammars
    get a bucket of an r-kernel, and the batch decodes bit-exact."""
    batch = _batch()
    plan = MicwDecodePlan([b for b, _px in batch], CPU)
    kinds = {(k[0], k[4]) for k in plan.buckets}
    assert {k for k, _d in kinds} == {"zzr", "vdr", "pdr", "azzr", "avdr", "apdr"}
    assert ("pdr", False) in kinds and ("azzr", False) in kinds
    assert plan.verify_batch(plan.run(), [px for _b, px in batch]) == 0


def test_mixed_batch_with_direct_fixtures(ref):
    """An auto-r container that mixes direct and r-mode strips (tissue
    rows over smooth noise: vdr, then zzd), decoded in one batch with
    direct-mode fixtures."""
    rng = np.random.default_rng(11)
    img = np.empty((128, 256), np.uint16)
    img[:64] = _plane("g").reshape(384, 512)[160:224, :256]
    img[64:] = (rng.standard_normal((64, 256)).cumsum(axis=1) * 9 + 700).clip(0, 4095)
    px = img.ravel()
    blob = ref[2].micw_compress(px, 256, 128, int(px.max()), num_strips=2,
                                predictor="auto-r", entropy="best")
    modes = [s[5] for s in st.micw_parse(blob)[7]]
    assert any(m in (st.STRIP_MODE_ZZR, st.STRIP_MODE_VDR, st.STRIP_MODE_PDR) for m in modes)
    assert any(m in (st.STRIP_MODE_ZZD, st.STRIP_MODE_VDD, st.STRIP_MODE_PDD) for m in modes)
    mr = (TESTDATA / "MR_dev.micw").read_bytes(), np.fromfile(TESTDATA / "MR_dev.raw", "<u2")
    ct = ((PORT_DATA / "CT_dev_alias.micw").read_bytes(),
          np.fromfile(TESTDATA / "CT_dev.raw", "<u2"))
    batch = [(blob, px), mr, ct, (blob, px)]
    outs = micw_decode_many([b for b, _px in batch], CPU)
    for (out, _w, _h), (_b, want) in zip(outs, batch):
        assert np.array_equal(out, want)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_is_not_stale(ref, name):
    c, pred, ent = FIXTURES[name]
    blob = ref[2].micw_compress(_plane(c), 512, 384, 255, predictor=pred, entropy=ent)
    assert blob == (PORT_DATA / f"{name}.micw").read_bytes()


@pytest.mark.parametrize("ent", ["standard", "best"])
def test_round_trip_through_port(ent):
    """The port's device encoder (plain versions on the CPU) under auto-r
    writes the fixtures, and the port's plan decodes them bit-exact."""
    planes = [_plane(c) for c in "rgb"]
    blobs = micw_compress_device_many([(px, 512, 384, 255) for px in planes], CPU,
                                      entropy=ent, predictor="auto-r")
    names = [f"tissue_{c}_r{'std' if ent == 'standard' else 'best'}" for c in "rgb"]
    assert blobs == [(PORT_DATA / f"{n}.micw").read_bytes() for n in names]
    for (out, _w, _h), px in zip(micw_decode_many(blobs, CPU), planes):
        assert np.array_equal(out, px)


# ---------------------------------------------------------------------------
# (f) strips once outside the slice
# ---------------------------------------------------------------------------


def _smooth_blob(ref_st, pred, w, h=16):
    rng = np.random.default_rng(3)
    px = (rng.standard_normal((h, w)).cumsum(axis=1) * 9 + 700).clip(0, 4095)
    px = px.astype(np.uint16).ravel()
    return ref_st.micw_compress(px, w, h, int(px.max()), num_strips=1, predictor=pred), px


@pytest.mark.parametrize("pred,width,match", [
    ("zzr", 192, "zzr strip of width 192"),
    ("pdr", 320, "pdr strip of width 320"),
    ("vdr", 384, "vdr strip of width 384"),
    ("zz", 256, "mode 3 \\(zz\\)"),
])
def test_out_of_slice_raises(ref, pred, width, match):
    """These strips raised NotImplementedError (``match``) before the post
    path; now they take it and decode bit-exact against the pixels and
    ``micw_decompress_host``."""
    blob, px = _smooth_blob(ref[2], pred, width)
    assert st.micw_parse(blob)[7][0][5] == st._PRED_MODE[pred]
    plan = MicwDecodePlan([blob], CPU)
    assert [k[:3] for k in plan.buckets] == [("post", "packed", pred)], match
    ((out, w, h),) = plan.assemble(plan.run())
    assert np.array_equal(out, px)
    host, _hw, _hh = ref[2].micw_decompress_host(blob)
    assert np.array_equal(out, np.asarray(host).ravel())


# ---------------------------------------------------------------------------
# (g) dishonest streams
# ---------------------------------------------------------------------------


def _entry_at(i):
    """Byte offset of strip ``i``'s table entry (no FLAG_BANDED)."""
    return st.MICW_HEADER + i * st.MICW_ENTRY


def _dishonest_blobs():
    """name -> damaged fixture container.  A damaged table entry makes the
    plan raise or decode garbage, never read out of bounds."""
    good = (PORT_DATA / "tissue_g_rstd.micw").read_bytes()
    alias = (PORT_DATA / "tissue_g_zzr_alias.micw").read_bytes()
    out = {}
    for label, blob in (("std", good), ("alias", alias)):
        b = bytearray(blob)
        struct.pack_into("<I", b, _entry_at(1) + 20, 0xFFFFFFFF)  # nSame
        out[f"{label}_nsame_huge"] = bytes(b)
        b = bytearray(blob)
        struct.pack_into("<I", b, _entry_at(0) + 16, 40)  # nRuns: counts cut short
        out[f"{label}_nruns_short"] = bytes(b)
        b = bytearray(blob)
        mict = st.micw_parse(bytes(b))[7][2][0]
        at = bytes(b).find(mict)
        count = struct.unpack_from("<I", b, at + 4)[0]
        struct.pack_into("<I", b, at + 4, count // 3)  # MICT count truncated
        out[f"{label}_count_truncated"] = bytes(b)
    return out


def _dishonest_operands(plan):
    """(fn, ops, kwargs) variants of the plan's r-buckets with run counts
    past the tables: nrun beyond maxr, nrun negative (a u32 count >= 2^31),
    nsame beyond the symbols, and a lying ``dense``."""
    out = []
    for b in plan.buckets.values():
        if b.fn not in PLAIN:
            continue
        kw = b.kwargs
        ops = list(b.ops)
        for i, v in ((-2, kw["maxr"] + 300), (-2, -7), (-1, kw["steps"] * 128 + 5)):
            bad = list(ops)
            bad[i] = torch.full_like(ops[i], v)
            out.append((b.fn, bad, kw))
        out.append((b.fn, ops, dict(kw, dense=not kw["dense"])))
    return out


@pytest.mark.parametrize("name", sorted(_dishonest_blobs()))
def test_dishonest_blobs_stay_in_bounds(name):
    blob = _dishonest_blobs()[name]
    try:
        plan = MicwDecodePlan([blob], CPU)
    except ValueError:
        assert "nruns" in name or "count" in name
        return
    ((out, w, h),) = plan.assemble(plan.run())
    assert out.dtype == np.uint16 and out.size == w * h == 512 * 384


def test_dishonest_operands_stay_in_bounds():
    plan = MicwDecodePlan([_fixture("tissue_g_pdr")[0], _fixture("tissue_g_zzr_alias")[0]],
                          CPU)
    cases = _dishonest_operands(plan)
    assert len(cases) >= 8
    for fn, ops, kw in cases:
        out = fn(*ops, **kw)
        assert out.shape == (ops[0].shape[0], kw["out_rows"], 128)


def test_lying_dense_flag(ref, monkeypatch):
    """A legacy-grammar blob that claims FLAG_RDENSE: the 32-run window
    misses runs, so the pixels are garbage, but the decode stays in
    bounds (the Pallas kernel's 32 candidates miss them too)."""
    blob, px = _grammar_blob(ref[2], monkeypatch, "minimal_runs_legacy")
    lying = bytearray(blob)
    lying[22] |= st.FLAG_RDENSE
    ((out, _w, _h),) = micw_decode_many([bytes(lying)], CPU)
    assert out.size == px.size and not np.array_equal(out, px)
    ((out, _w, _h),) = micw_decode_many([blob], CPU)
    assert np.array_equal(out, px)


# ---------------------------------------------------------------------------
# Wrapper contract (CPU) and the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


def test_wrapper_cpu_takes_plain_and_counts_nothing():
    plan = MicwDecodePlan([_fixture("tissue_g_pdr")[0]], CPU)
    b = next(b for b in plan.buckets.values() if b.fn is rd.rans_decode_rle)
    before = rd.rans_decode_rle.launches
    out = b.fn(*b.ops, **b.kwargs)
    assert rd.rans_decode_rle.launches == before
    assert torch.equal(out, rd.rans_decode_rle_plain(*b.ops, **b.kwargs))


@pytest.mark.parametrize("fault", ["nrun_shape", "out_rows", "maxr", "maxr_steps", "vdd_ws"])
def test_wrapper_rejects_bad_operands(fault):
    plan = MicwDecodePlan([_fixture("tissue_g_zzr_alias")[0]], CPU)
    b = next(iter(plan.buckets.values()))
    ops, kw = list(b.ops), dict(b.kwargs)
    if fault == "nrun_shape":
        ops[-2] = ops[-2][:, :64].contiguous()
    elif fault == "out_rows":
        kw["out_rows"] = 12
    elif fault == "maxr":
        kw["maxr"] = 1000
    elif fault == "maxr_steps":
        kw["maxr"] = (kw["steps"] + 8) * 128
    else:
        kw["vdd_ws"] = 3
    with pytest.raises(ValueError):
        rd.rans_decode_rle_alias(*ops, **kw)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Every r-bucket of the fixture batch, with its own ``dense`` and the
    other one, kernel == plain on the whole array."""
    dev = _need_cuda()
    plan = MicwDecodePlan([b for b, _px in _batch()], dev)
    checked = 0
    for b in plan.buckets.values():
        for dense in (True, False):
            kw = dict(b.kwargs, dense=dense)
            before = b.fn.launches
            got = b.fn(*b.ops, **kw)
            torch.cuda.synchronize()
            assert b.fn.launches == before + 1
            assert torch.equal(got, PLAIN[b.fn](*b.ops, **kw)), kw
            checked += 1
    assert checked >= 24


@pytest.mark.cuda
def test_cuda_fixture_batch_decodes():
    dev = _need_cuda()
    batch = _batch()
    rd.rans_decode_rle_groups.launches = 0
    plan = MicwDecodePlan([b for b, _px in batch], dev)
    decoded = plan.run()
    assert plan.verify_batch(decoded, [px for _b, px in batch]) == 0
    assert rd.rans_decode_rle_groups.launches == 1  # every r-bucket, both front ends
    for (out, _w, _h), (_b, px) in zip(plan.assemble(decoded), batch):
        assert np.array_equal(out, px)


@pytest.mark.cuda
def test_cuda_dishonest_streams_match_plain():
    dev = _need_cuda()
    checked = 0
    for blob in _dishonest_blobs().values():
        try:
            plan = MicwDecodePlan([blob], dev)
        except ValueError:
            continue
        for b in plan.buckets.values():
            got = b.fn(*b.ops, **b.kwargs)
            torch.cuda.synchronize()
            assert torch.equal(got, PLAIN[b.fn](*b.ops, **b.kwargs))
            checked += 1
    plan = MicwDecodePlan([_fixture("tissue_g_pdr")[0], _fixture("tissue_g_zzr_alias")[0]],
                          dev)
    for fn, ops, kw in _dishonest_operands(plan):
        got = fn(*ops, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, PLAIN[fn](*ops, **kw)), kw
        checked += 1
    assert checked >= 12


# ---------------------------------------------------------------------------
# The merged launch: plain twin, packing, honesty test, parallel expand
# ---------------------------------------------------------------------------


def _mixed_batch(ref_st):
    """An auto-r container of r-mode and direct strips beside direct-mode
    fixtures and two r-mode fixtures: (blob, pixels) pairs."""
    rng = np.random.default_rng(11)
    img = np.empty((128, 256), np.uint16)
    img[:64] = _plane("g").reshape(384, 512)[160:224, :256]
    img[64:] = (rng.standard_normal((64, 256)).cumsum(axis=1) * 9 + 700).clip(0, 4095)
    px = img.ravel()
    blob = ref_st.micw_compress(px, 256, 128, int(px.max()), num_strips=2,
                                predictor="auto-r", entropy="best")
    mr = (TESTDATA / "MR_dev.micw").read_bytes(), np.fromfile(TESTDATA / "MR_dev.raw", "<u2")
    return [(blob, px), mr, _fixture("tissue_g_pdr"), _fixture("tissue_b_rbest")]


def _groups_of(plan):
    return [plan.buckets[k].launch for k in plan._rle_keys]


@pytest.mark.parametrize("batch", ["fixtures", "mixed"])
def test_groups_plain_equals_per_bucket(ref, batch):
    """The merged launch's plain twin (what the plan runs on the CPU)
    equals each bucket's own plain r-kernel, and the plan's run equals
    the bucket calls one by one."""
    pairs = _batch() if batch == "fixtures" else _mixed_batch(ref[2])
    plan = MicwDecodePlan([b for b, _px in pairs], CPU)
    groups = _groups_of(plan)
    assert groups and len(groups) == sum(b.fn in PLAIN for b in plan.buckets.values())
    merged = rd.rans_decode_rle_groups(groups)
    for (fn, ops, kw), got in zip(groups, merged):
        assert torch.equal(got, PLAIN[fn](*ops, **kw)), kw
    run = plan.run()
    for k, b in plan.buckets.items():
        assert torch.equal(run[k], b()), k
    assert plan.verify_batch(run, [px for _b, px in pairs]) == 0


def test_rle_packing_layout():
    """Descriptors of the fixture batch: one launch for both front ends,
    outputs laid out group after group, every strip once, longest chain
    first, each group's arguments and operand pointers."""
    plan = MicwDecodePlan([b for b, _px in _batch()], CPU)
    groups = _groups_of(plan)
    pk = rd.RlePacking(groups)
    assert pk.families == ["rans_decode_rle", "rans_decode_rle_alias"]
    at = 0
    for (fn, ops, kw), off, shape, d in zip(groups, pk.out_offs, pk.out_shapes, pk.desc):
        S = ops[0].shape[0]
        assert off == at and shape == (S, kw["out_rows"], 128)
        at += S * kw["out_rows"] * 128
        alias = fn is rd.rans_decode_rle_alias
        assert d["arg"].tolist() == [
            int(alias), 0 if alias else ops[1].shape[1], 0 if alias else ops[2].shape[1],
            ops[4 if alias else 3].shape[1], ops[8].shape[1] if alias else 0, kw["steps"],
            kw["out_rows"], kw["maxr"], kw["vdd_ws"], int(kw["dense"]), int(kw.get("esc", 0)), 0]
        ptrs = [t.data_ptr() for t in ops]
        if not alias:
            ptrs = ptrs[:3] + [0] + ptrs[3:6] + [0, 0] + ptrs[6:]
        assert d["ptr"].tolist() == ptrs
        assert d["off"][2] == -1  # maxr 1024: run tables in shared memory
    assert pk.out_total == at
    assert pk.tab_words == max(384, max(ops[1].shape[1] + ops[2].shape[1]
                                        for fn, ops, _kw in groups if fn is rd.rans_decode_rle))
    assert pk.st_words == 2 * max(kw["maxr"] for _fn, _ops, kw in groups)
    pairs = pk.blocks.tolist()
    assert sorted(pairs) == [[g, s] for g, (_f, ops, _k) in enumerate(groups)
                             for s in range(ops[0].shape[0])]
    chain = [(groups[g][2]["steps"], groups[g][2]["out_rows"]) for g, _s in pairs]
    assert chain == sorted(chain, reverse=True)
    assert pk.holds(groups) and not pk.holds(groups[::-1])
    # a run table past RLE_ST_SMEM_MAX entries takes device scratch
    fn, ops, kw = groups[0]
    big = dict(kw, maxr=kw["steps"] * 128)
    assert big["maxr"] > rd.RLE_ST_SMEM_MAX
    pk2 = rd.RlePacking([(fn, ops, big), groups[1]])
    assert pk2.desc["off"][:, 2].tolist() == [0, -1]
    assert pk2.st_total == ops[0].shape[0] * 2 * big["maxr"]


def test_groups_reject_bad_arguments():
    plan = MicwDecodePlan([_fixture("tissue_g_zzr_alias")[0]], CPU)
    groups = _groups_of(plan)
    with pytest.raises(ValueError):
        rd._rle_launch(rd.RlePacking(groups), "fastest")
    fn, ops, kw = groups[0]
    with pytest.raises(ValueError):  # the route is not picked from the first group alone
        rd.rans_decode_rle_groups([groups[0], (fn, tuple(o.to("meta") for o in ops), kw)])
    with pytest.raises(ValueError):
        rd.RlePacking([(rd.rans_decode_zzd, groups[0][1], groups[0][2])])
    with pytest.raises(ValueError):
        rd.RlePacking([])
    with pytest.raises(ValueError):
        rd.RlePacking([(fn, ops, dict(kw, vdd_ws=3))])


def test_bucket_packing_kept_for_the_same_tensors():
    """A one-bucket wrapper reuses its last packing only for the very
    tensors and arguments it was built for."""
    plan = MicwDecodePlan([_fixture("tissue_g_pdr")[0], _fixture("tissue_g_zzr_alias")[0]], CPU)
    (fn, ops, kw), other = _groups_of(plan)[:2]
    first = rd._bucket_packing(fn, ops, kw)
    assert rd._bucket_packing(fn, ops, dict(kw)) is first
    assert first.holds([(fn, ops, kw)]) and first.blocks.tolist() == [
        [0, s] for s in range(ops[0].shape[0])]
    flipped = rd._bucket_packing(fn, ops, dict(kw, dense=not kw["dense"]))
    assert flipped is not first and flipped.desc["arg"][0, 9] == int(not kw["dense"])
    copies = tuple(o.clone() for o in ops)
    assert rd._bucket_packing(fn, copies, kw) is not flipped
    assert rd._bucket_packing(*other) is not rd._bucket_packing(fn, copies, kw)


def _group_symbols(fn, ops, kw):
    """The decoded symbols of one group (int64 [S, steps * 128])."""
    if fn is rd.rans_decode_rle:
        return torch.cat(list(rd._packed_symbols(*ops[:6], kw["steps"])), dim=1)
    return torch.cat(list(rd._alias_symbols(*ops[:9], kw["steps"], kw["esc"])), dim=1) & 0xFFFF


def _honest(fn, ops, kw):
    return rd.rle_honest(_group_symbols(fn, ops, kw), ops[-2], ops[-1], steps=kw["steps"],
                         maxr=kw["maxr"], dense=kw["dense"])


def _parallel_mirror(fn, ops, kw):
    """The kernel's parallel expand in torch: each pixel's run is the last
    run whose start <= its position over the whole table, the literal
    cursor the serial recursion over each row's literal count, then the
    inverse as its scans (vdr: per column over the image rows; zzr / pdr:
    the row prefix with its carry over ws lane-rows)."""
    steps, out_rows, maxr, vws = kw["steps"], kw["out_rows"], kw["maxr"], kw["vdd_ws"]
    syms = _group_symbols(fn, ops, kw)
    st1, st2, nrun, nsame = rd._rle_tables_plain(syms, ops[-2], ops[-1], steps=steps,
                                                 maxr=maxr)
    S = syms.shape[0]
    c = torch.arange(maxr)[None, :]
    starts = torch.where(c < nrun, st1 >> 1, 1 << 40).contiguous()
    pos = torch.arange(out_rows * 128)[None, :].expand(S, -1).contiguous()
    r = (torch.searchsorted(starts, pos, right=True) - 1).clamp(min=0)
    g1, g2 = torch.gather(st1, 1, r), torch.gather(st2, 1, r)
    lit = (g1 & 1) == 0
    count = lit.view(S, out_rows, 128).sum(-1)
    lc = [nrun + nsame]
    for t in range(out_rows - 1):
        lc.append((lc[-1] + count[:, t:t + 1]).clamp(max=steps * 128 - 1))
    lrow = (torch.cat(lc, dim=1) >> 7).clamp(max=steps - 2).repeat_interleave(128, dim=1)
    li = (g2 + pos - (lrow << 7)).clamp(0, 255)
    tok = torch.where(lit, torch.gather(syms, 1, (lrow << 7) + li), g2)
    si = ((tok & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    dz = ((si >> 1) ^ (-(si & 1))).view(S, out_rows, 128)
    if vws:
        img = dz.view(S, out_rows // vws, vws * 128).cumsum(dim=1)
        return rd._as_i16(img.reshape(S, out_rows, 128))
    ws = ops[-3][:, :1].to(torch.int64)
    tot = dz.sum(-1)
    pix = torch.empty_like(dz)
    rowc = torch.zeros((S, 1), dtype=torch.int64)
    for t in range(out_rows):
        rowc = torch.where((t % ws) == 0, 0, rowc)
        pix[:, t] = rowc + dz[:, t].cumsum(dim=1)
        rowc = rowc + tot[:, t:t + 1]
    return rd._as_i16(pix)


def test_honesty_mirror_accepts_fixture_strips():
    """Every strip of the fixture batch passes the honesty test, and the
    parallel expand decodes each bit for bit as the serial plain twin."""
    plan = MicwDecodePlan([b for b, _px in _batch()], CPU)
    for fn, ops, kw in _groups_of(plan):
        assert bool(_honest(fn, ops, kw).all()), kw
        assert torch.equal(_parallel_mirror(fn, ops, kw), PLAIN[fn](*ops, **kw)), kw


def _lying_dense_blob(monkeypatch):
    """The legacy-grammar stream of ``minimal_runs_legacy`` (same-runs of
    >= 3 px) under FLAG_RDENSE, written by the port's encoder (which
    writes mic_tpu's bytes; jax-free, so the card's tests can build it)."""
    px = _minimal_runs()
    monkeypatch.setattr(st, "RDENSE_MIN_SAME", 3)
    (blob,) = micw_compress_device_many([(px, 128, 16, int(px.max()), 1)], CPU,
                                        entropy="alias", predictor="zzr")
    monkeypatch.undo()
    assert blob[22] & st.FLAG_RDENSE
    return blob, px


def _dishonest_cases(monkeypatch):
    """name -> (fn, operands, kwargs) of every dishonest r-group: the
    operand variants, the damaged blobs' buckets and the lying-dense blob's."""
    cases = {}
    plan = MicwDecodePlan([_fixture("tissue_g_pdr")[0], _fixture("tissue_g_zzr_alias")[0]], CPU)
    for i, (fn, ops, kw) in enumerate(_dishonest_operands(plan)):
        kind = ("nrun_past_maxr", "nrun_negative", "nsame_past_steps", "dense_flipped")[i % 4]
        cases[f"operands_{i // 4}_{kind}"] = (fn, ops, kw)
    for name, blob in _dishonest_blobs().items():
        try:
            plan = MicwDecodePlan([blob], CPU)
        except ValueError:
            continue
        for j, g in enumerate(_groups_of(plan)):
            cases[f"blob_{name}_{j}"] = g
    (cases["lying_dense"],) = _groups_of(MicwDecodePlan([_lying_dense_blob(monkeypatch)[0]],
                                                        CPU))
    return cases


def test_honesty_mirror_on_dishonest_cases(monkeypatch):
    """Counts out of range and the lying-dense blob fail the test (the
    32-run window misses runs there); a case that passes (damaged counts
    whose runs stay strictly increasing, FLAG_RDENSE cleared on a dense
    stream) decodes bit for bit as the serial plain twin in the parallel
    form, so passing it is safe."""
    cases = _dishonest_cases(monkeypatch)
    assert len(cases) >= 20
    for name, (fn, ops, kw) in cases.items():
        honest = _honest(fn, ops, kw)
        if name.endswith(("past_maxr", "negative", "past_steps")) or name == "lying_dense":
            assert not bool(honest.any()), name
        keep = honest.nonzero()[:, 0]
        if len(keep):
            sub = tuple(o[keep].contiguous() for o in ops)
            assert torch.equal(_parallel_mirror(fn, sub, kw), PLAIN[fn](*sub, **kw)), name
    # where the test rejects, the parallel walk would decode other pixels
    fn, ops, kw = cases["lying_dense"]
    assert not torch.equal(_parallel_mirror(fn, ops, kw), PLAIN[fn](*ops, **kw))


@pytest.mark.cuda
def test_cuda_merged_kernel_matches_plain(monkeypatch):
    """The merged launch (both front ends, every r-bucket of the fixture
    batch) and each dishonest case, alone and all in one launch, kernel ==
    plain on whole arrays."""
    dev = _need_cuda()
    plan = MicwDecodePlan([b for b, _px in _batch()], dev)
    groups = _groups_of(plan)
    before = rd.rans_decode_rle_groups.launches
    got = rd.rans_decode_rle_groups(groups, plan.rle_packing)
    torch.cuda.synchronize()
    assert rd.rans_decode_rle_groups.launches == before + 1
    for g, (fn, ops, kw) in zip(got, groups):
        assert torch.equal(g, PLAIN[fn](*ops, **kw)), kw
    cases = [(fn, tuple(o.to(dev) for o in ops), kw)
             for fn, ops, kw in _dishonest_cases(monkeypatch).values()]
    for fn, ops, kw in cases:
        (g,) = rd.rans_decode_rle_groups([(fn, ops, kw)])
        torch.cuda.synchronize()
        assert torch.equal(g, PLAIN[fn](*ops, **kw)), kw
    for g, (fn, ops, kw) in zip(rd.rans_decode_rle_groups(cases), cases):
        assert torch.equal(g, PLAIN[fn](*ops, **kw)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["serial", "parallel", "auto"])
def test_cuda_forced_forms_match_plain(form):
    """Each expand forced on the honest fixture strips, kernel == plain."""
    dev = _need_cuda()
    plan = MicwDecodePlan([b for b, _px in _batch()], dev)
    groups = _groups_of(plan)
    for g, (fn, ops, kw) in zip(rd._rle_launch(plan.rle_packing, form), groups):
        torch.cuda.synchronize()
        assert torch.equal(g, PLAIN[fn](*ops, **kw)), (form, kw)


@pytest.mark.cuda
def test_cuda_run_tables_in_device_memory():
    """Run tables past RLE_ST_SMEM_MAX entries take device scratch: a
    bucket at maxr = steps * 128 (16384 or 32768 entries) beside one in
    shared memory, in one launch, kernel == plain."""
    dev = _need_cuda()
    plan = MicwDecodePlan([_fixture("tissue_g_pdr")[0], _fixture("tissue_g_zzr_alias")[0]], dev)
    groups = _groups_of(plan)
    fn, ops, kw = groups[0]
    big = dict(kw, maxr=kw["steps"] * 128)
    assert big["maxr"] > rd.RLE_ST_SMEM_MAX
    cases = [(fn, ops, big), groups[-1]]
    packing = rd.RlePacking(cases)
    assert packing.desc["off"][:, 2].tolist() == [0, -1]
    for form in ("auto", "serial"):
        for g, (f, o, k) in zip(rd._rle_launch(packing, form), cases):
            torch.cuda.synchronize()
            assert torch.equal(g, PLAIN[f](*o, **k)), (form, k)
