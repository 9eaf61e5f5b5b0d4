"""The port's scan tier against mic_tpu's: the host L-lane encoder copies,
the lanes kernel's plain twin, the plans that route strips there, the
single-stream decode and the RLE expand.

Tolerance 0 everywhere: a lossless codec, byte-identical containers.

* The copies, byte for byte: ``mict_encode`` / ``mict_encode_alias`` /
  ``_lane_encode`` / ``mict_decode_numpy`` and the host
  ``micw_compress`` at 8, 64, 128 and 256 lanes, every entropy family and
  the auto-fast, zzd, avg and auto-r trial sets.
* ``decode_strip_batch`` against ``decode_strip_batch_impl`` on the
  operands of the graft entry's tiny 64-lane batch, on whole arrays.
* ``MicwDecodePlan``, ``micw_decompress_scan`` and ``micw_decode_batch``
  against ``micw_decompress_host`` and ``mic_tpu``'s scan tier: the
  format-freeze shapes at 64 lanes, 8-, 32- and 512-lane containers, and
  one plan that mixes 128-lane, 64-lane and FF 41 tableLog 13-16 strips
  (the fixtures ``tests/data/torch_port/CT_dev_alias_tl*.micw``, written
  by :func:`alias_reencode`).
* ``decode.mict_decode_device`` and ``post.rle_expand`` against their
  ``mic_tpu`` counterparts; damaged streams through the scan tier.

The ``cuda`` tests hold the lanes kernel to its plain twin on the card,
in both forms (a warp a strip, and a block a strip, symbols out); they
skip without a GPU.  ``mic_tpu`` is imported through the ``ref``
fixture: the machine with the card has no jax.
"""

import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mic_tpu_torch import MicwDecodePlan, micw_decode_batch, micw_decompress_scan
from mic_tpu_torch.tpu import decode as port_decode
from mic_tpu_torch.tpu import device_rans as dr
from mic_tpu_torch.tpu import post
from mic_tpu_torch.tpu import scan_decode as sd
from mic_tpu_torch.tpu import strips as st

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "web" / "testdata"
PORT_DATA = ROOT / "tests" / "data" / "torch_port"
CPU = torch.device("cpu")
# tableLog -> (fixture, lanes): CT_dev's strips as FF 41 above tableLog 12
ALIAS_FIXTURES = {13: (PORT_DATA / "CT_dev_alias_tl13_l64.micw", 64),
                  14: (PORT_DATA / "CT_dev_alias_tl14.micw", 128),
                  15: (PORT_DATA / "CT_dev_alias_tl15.micw", 128),
                  16: (PORT_DATA / "CT_dev_alias_tl16_l64.micw", 64)}


@pytest.fixture(scope="module")
def ref():
    """mic_tpu's host format code and its scan tier (needs jax)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from mic_tpu.ops import fse
    from mic_tpu.parallel import multiframe
    from mic_tpu.tpu import decode, device_rans, pipeline, strips

    return SimpleNamespace(jnp=jnp, fse=fse, dr=device_rans, dec=decode, pl=pipeline,
                           st=strips, mf=multiframe)


def _smooth(seed, h, w, scale=9, base=700, spikes=0.0):
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((h, w)).cumsum(axis=1) * scale + base).clip(0, 4095)
    img = img.astype(np.uint16)
    if spikes:
        img[rng.random((h, w)) < spikes] = 4000
    return img.ravel()


def _ct():
    return np.fromfile(TESTDATA / "CT_dev.raw", dtype="<u2")


def encode_at(d, syms, table_log, lanes, alias=True):
    """One MICT stream of ``syms`` at exactly ``table_log`` and ``lanes``,
    from the encode functions of ``d`` (``mic_tpu.tpu.device_rans`` or the
    port's copy): FF 41 with ``_alias_plan`` keeping the 255 most frequent
    values, lowered by 64 until ``alias_construct`` finds a layout, then
    ``_alias_apply`` and ``_lane_encode`` with the alias slot map; or FF
    57 through ``_norm_and_header`` and ``_lane_encode``.  Laid out as
    ``mict_encode_alias`` / ``mict_encode`` lay out a stream; their
    adaptive tableLog would pick another."""
    n = len(syms)
    counts, _mx, sl = d.histogram(syms)
    counts = np.asarray(counts[:sl], np.int64)
    if not alias:
        norm, header = d._norm_and_header(counts, n, table_log, sl)
        freq, cumul = d.encode_tables(norm, table_log)
        states, words = d._lane_encode(syms.astype(np.int64), n, lanes, table_log, freq, cumul)
        return (d.MICT_MAGIC + struct.pack("<BBII", int(np.log2(lanes)), table_log, n,
                                           len(words))
                + header + states.astype("<u4").tobytes() + words.astype("<u2").tobytes())
    kept = min(int((counts > 0).sum()), d.ALIAS_MAX_KEPT)
    while True:
        kept_vals, counts2, sl2, esc_val = d._alias_plan(counts, sl, kept)
        norm, header = d._norm_and_header(counts2, n, table_log, sl2)
        freq, cumul = d.encode_tables(norm, table_log)
        try:
            al = d.alias_construct(norm, table_log)
            break
        except d.AliasInfeasible:
            kept -= 64
    recoded, esc = d._alias_apply(syms, kept_vals, esc_val)
    states, words = d._lane_encode(recoded, n, lanes, table_log, freq, cumul,
                                   slot_of=al["slot_of"].astype(np.uint64))
    return (d.MICT_ALIAS_MAGIC + struct.pack("<BBII", int(np.log2(lanes)), table_log, n,
                                             len(words))
            + struct.pack("<IH", len(esc), esc_val) + header
            + states.astype("<u4").tobytes() + words.astype("<u2").tobytes()
            + esc.astype("<u2").tobytes())


def alias_reencode(ref, blob, table_log, lanes):
    """``blob`` with every entropy strip's symbols (``mict_decode_numpy``)
    re-encoded as FF 41 at ``table_log`` and ``lanes`` by :func:`encode_at`
    with ``mic_tpu``'s own functions.  ``mic_tpu``'s encoders cap FF 41 at
    tableLog 12; its decoders take these streams.  The table entries and
    the header stay, with the container's lane count set to ``lanes``.
    This wrote the ``ALIAS_FIXTURES`` from ``web/testdata/CT_dev.micw``."""
    _w, _h, _ns, _sh, _mv, gpred, _lanes, strips = ref.st.micw_parse(blob)
    hdr = st.MICW_HEADER + (8 if blob[22] & st.FLAG_BANDED else 0)
    out = [encode_at(ref.dr, ref.dr.mict_decode_numpy(s[0]), table_log, lanes)
           if ref.st.strip_predictor(gpred, s[5]) is not None else s[0] for s in strips]
    table = bytearray(blob[hdr:hdr + len(strips) * st.MICW_ENTRY])
    off = 0
    for i, b in enumerate(out):
        struct.pack_into("<II", table, i * st.MICW_ENTRY, off, len(b))
        off += len(b)
    head = bytearray(blob[:hdr])
    head[23] = int(np.log2(lanes))
    return bytes(head) + bytes(table) + b"".join(out)


# ---------------------------------------------------------------------------
# (a) the host encoder copies, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lanes", [8, 64, 128, 256])
def test_mict_encode_copies(ref, lanes):
    rng = np.random.default_rng(lanes)
    data = np.minimum(rng.geometric(0.02, 5000), 700).astype(np.uint16)
    wide = (np.abs(rng.standard_normal(6000)) * 900).astype(np.uint16)  # escapes under FF 41
    for syms in (data, wide):
        for kw in ({}, {"table_log": 12, "max_table_log": 11}, {"alias": True},
                   {"alias": True, "counts": np.bincount(syms)}):
            want = _outcome(ref.dr.mict_encode, syms, lanes=lanes, **kw)
            assert _outcome(dr.mict_encode, syms, lanes=lanes, **kw) == want, kw
            if isinstance(want, bytes):
                assert np.array_equal(dr.mict_decode_numpy(want), ref.dr.mict_decode_numpy(want))
                assert np.array_equal(dr.mict_decode_numpy(want), syms)
        assert _outcome(dr.mict_encode_alias, syms, lanes=lanes) == _outcome(
            ref.dr.mict_encode_alias, syms, lanes=lanes)
    assert len(dr.mict_parse(dr.mict_encode_alias(data, lanes=lanes))[7][1])  # escapes
    freq, cumul = dr.encode_tables(*_norm(data))
    s64 = data.astype(np.int64)
    got = dr._lane_encode(s64, len(data), lanes, 11, freq, cumul)
    want = ref.dr._lane_encode(s64, len(data), lanes, 11, freq, cumul)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    with pytest.raises(dr.UseRLEError):
        dr.mict_encode(np.full(100, 7, np.uint16), lanes=lanes)
    with pytest.raises(ValueError, match="counts shorter"):
        dr.mict_encode(data, lanes=lanes, counts=np.ones(3, np.uint32))


def _outcome(fn, *args, **kw):
    """``fn``'s blob, or the name of the exception it raised."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the two packages raise their own classes
        return type(e).__name__


def _norm(data):
    counts, _mx, sl = dr.histogram(data)
    norm, _hdr = dr._norm_and_header(counts, len(data), 11, sl)
    return norm, 11


@pytest.mark.parametrize("lanes", [8, 64, 128, 256])
@pytest.mark.parametrize("entropy", ["standard", "alias", "best"])
@pytest.mark.parametrize("predictor", ["auto-fast", "zzd", "avg", "auto-r"])
def test_micw_compress_copy(ref, lanes, entropy, predictor):
    px = _smooth(lanes + len(predictor), 40, 72, spikes=0.02)
    mx = int(px.max())
    want = ref.st.micw_compress(px, 72, 40, mx, num_strips=2, lanes=lanes,
                                predictor=predictor, entropy=entropy)
    assert st.micw_compress(px, 72, 40, mx, num_strips=2, lanes=lanes, predictor=predictor,
                            entropy=entropy) == want
    out, w, h = st.micw_decompress_device(want, CPU)
    assert (w, h) == (72, 40) and np.array_equal(out, px)


def test_alias_escape_substitution_copy(ref):
    syms = np.array([3, 9, 3, 1, 9], np.uint16)
    alias = (9, np.array([700, 800], np.uint16))
    assert np.array_equal(dr.alias_substitute_escapes(syms, alias),
                          ref.dr.alias_substitute_escapes(syms, alias))
    with pytest.raises(ValueError, match="escape count"):
        dr.alias_substitute_escapes(syms, (9, np.zeros(0, np.uint16)))


# ---------------------------------------------------------------------------
# (b) the lanes kernel's operands and plain twin
# ---------------------------------------------------------------------------


def _tiny_batch(ref, lanes=64, num_strips=4, h=32, w=64):
    """The operands of ``__graft_entry__._tiny_micw_batch``, rebuilt."""
    rng = np.random.default_rng(0)
    img = (rng.standard_normal((h, w)).cumsum(axis=1) * 8 + 512).astype(np.int32)
    img = (img >> 2 << 2).clip(0, 1023).astype(np.uint16)
    blob = ref.st.micw_compress(img.ravel(), w, h, int(img.max()), num_strips=num_strips,
                                lanes=lanes, predictor="zzd")
    width, _h, _n, strip_h, max_value, _p, _l, strips = ref.st.micw_parse(blob)
    parsed = [ref.dr.mict_parse(b) for b, *_ in strips]
    tl = max(p[1] for p in parsed)
    arrays, meta = ref.st.build_strip_batch(parsed, strips, tl, pad_strips_to=num_strips)
    delim = int(ref.st.delta_params(max_value)[1])
    kw = dict(table_log=tl, n_steps=meta["n_steps"], width=width, strip_h=strip_h,
              max_runs=meta["max_runs"], max_tokens=meta["max_tokens"],
              mid_count=(1 << (delim.bit_length() - 1)) - 1, delim=delim, predictor="zzd")
    return arrays, kw, img.ravel()


def test_decode_strip_batch_matches_graft_step(ref):
    arrays, kw, px = _tiny_batch(ref)
    want = np.asarray(ref.st._decode_strip_batch(*[ref.jnp.asarray(a) for a in arrays], **kw))
    got = sd.decode_strip_batch(*arrays, **kw, device=CPU)
    assert got.dtype == torch.int16 and got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.uint16), want)
    assert np.array_equal(want.reshape(-1)[: px.size], px)


def test_build_lane_tables_mirrors_build_strip_batch(ref):
    """FF 41 with and without escapes and FF 57, one tableLog, 32 lanes."""
    rng = np.random.default_rng(3)
    streams = [np.minimum(rng.geometric(0.02, n), 700).astype(np.uint16)
               for n in (3000, 2900, 2800)]
    blobs = [dr.mict_encode_alias(streams[0], lanes=32, table_log=11, max_table_log=11),
             dr.mict_encode_alias(np.minimum(streams[1], 60), lanes=32, table_log=11,
                                  max_table_log=11),
             dr.mict_encode(streams[2], lanes=32, table_log=11, max_table_log=11)]
    parsed = [dr.mict_parse(b) for b in blobs]
    tl = parsed[0][1]
    assert [p[1] for p in parsed] == [tl] * 3
    assert len(parsed[0][7][1]) and not parsed[1][7][1].size
    strips = [(b, p[2], p[2], 0, 0, st.STRIP_MODE_ZZD) for b, p in zip(blobs, parsed)]
    want, meta = ref.st.build_strip_batch(parsed, strips, tl)
    init, words, tsym, tf, tb, toff, tls, counts, escv, esides, steps = \
        sd.build_lane_tables(parsed + parsed[:1])  # a repeated parse shares its table
    S = len(parsed)
    assert steps == meta["n_steps"] and list(toff) == [0, 1 << tl, 2 << tl, 0]
    assert np.array_equal(init[:S], want[0]) and np.array_equal(words[:S], want[1])
    for a, w in ((tsym, want[2]), (tf, want[3]), (tb, want[4])):
        assert np.array_equal(a.reshape(-1, 1 << tl)[:S], w)
    assert np.array_equal(counts[:S], want[5]) and np.array_equal(escv[:S], want[9])
    assert np.array_equal(esides[:S], want[10]) and list(tls) == [tl] * (S + 1)
    assert list(escv[:S] >= 0) == [True, False, False]


def _bucket_slots(abk, tl):
    """Every slot of a tableLog-``tl`` stream through its bucket table
    (u32 [128, 4]) as ``csrc/rans_lanes.cu``'s bucket front end reads it:
    (sym, freq, bias) a slot, numpy u32 arithmetic."""
    slot = np.arange(1 << tl, dtype=np.uint32)
    q = abk[np.minimum(slot >> np.uint32(tl - 7), 127)]
    off = slot & np.uint32((1 << (tl - 7)) - 1)
    is_p = off < (q[:, 0] >> 18)
    bw = np.where(is_p, q[:, 1], q[:, 3])
    freq = np.where(is_p, q[:, 0], q[:, 2]) & np.uint32(0x3FFFF)
    bias = (bw + off) & np.uint32(0x1FFFF)
    sym = (bw >> 17) | ((q[:, 2] >> np.where(is_p, 3, 4).astype(np.uint32)) & np.uint32(0x8000))
    return sym, freq, bias


def _alias_layout(syms, tl):
    """``syms``' FF 41 norm at exactly ``tl`` and its alias layout, the
    kept values lowered by 64 until the layout exists (as
    :func:`encode_at` does; below tableLog 8 also until the table holds
    them)."""
    counts, _mx, sl = dr.histogram(syms)
    counts = np.asarray(counts[:sl], np.int64)
    kept = min(int((counts > 0).sum()), dr.ALIAS_MAX_KEPT)
    while True:
        _vals, counts2, sl2, _esc = dr._alias_plan(counts, sl, kept)
        try:
            norm, _hdr = dr._norm_and_header(counts2, len(syms), tl, sl2)
            return norm, dr.alias_construct(norm, tl)
        except (dr.AliasInfeasible, ValueError):
            kept -= 64


def _same_slots(got, want):
    return all(np.array_equal(np.asarray(g, np.int64), np.asarray(w, np.int64))
               for g, w in zip(got, want))


@pytest.mark.parametrize("tl", list(range(7, 18)))
def test_alias_bucket_words_decode_every_slot(tl):
    """Alias norms at every tableLog the scan tier's FF 41 streams take
    (7-17): each slot decoded through ``alias_bucket_words`` equals
    ``alias_slot_tables``' (sym, freq, bias), symbols past 2^15 and a
    symbol holding most of the table included; at tableLog 17 the fields
    reach their widths (t 1024, fp, sbp, sba past 2^16, one symbol of
    all 2^17 slots)."""
    rng = np.random.default_rng(tl)
    layouts = []
    for base, p in ((0, 0.02), (32700, 0.01), (65000, 0.8)):
        syms = np.minimum(base + rng.geometric(p, 1 << 17), 65535).astype(np.uint16)
        syms[:50] = 65535
        layouts.append(_alias_layout(syms, tl))
    one = np.zeros(40001, np.int64)
    one[40000] = 1 << tl  # one symbol: every bucket full of it
    layouts.append((one, dr.alias_construct(one, tl)))
    if tl >= 9:  # 127 small symbols, each a bucket's primary, the large one their alias
        spread = np.zeros(65536, np.int64)
        spread[:127] = (1 << (tl - 7)) * 2 // 5
        spread[65535] = (1 << tl) - spread[:127].sum()
        layouts.append((spread, dr.alias_construct(spread, tl)))
    for norm, al in layouts:
        words = sd.alias_bucket_words(al)
        assert words.shape == (128, 4) and words.dtype == np.uint32
        assert _same_slots(_bucket_slots(words, tl), dr.alias_slot_tables(norm, tl)[:3])
    if tl == 17:
        al, one_al, spread_al = (layouts[i][1] for i in (2, 3, 4))
        assert al["t"].max() == 1024 and al["fp"].max() >= 1 << 16
        assert al["sbp"].max() >= 1 << 16 and spread_al["sba"].max() >= 1 << 16
        assert spread_al["a"].max() == 65535 and one_al["fp"].max() == 1 << 17


def test_bucket_tables_of_the_ct_slice():
    """The CT slice of the benchmark at 8 lanes, FF 41 (its four strips at
    tableLog 12): ``build_lane_operands`` gives each strip a bucket table
    whose every slot equals its slot tables and ``alias_slot_tables``; a
    repeated parse shares its tables, FF 57 strips and strips past
    ``WARP_LANES`` lanes have none."""
    px = np.fromfile(ROOT / "portbench" / "data" / "CT_512_512_image.raw", dtype="<u2")
    blob = st.micw_compress(px, 512, 512, int(px.max()), lanes=8, predictor="auto-fast",
                            entropy="alias")
    parsed = [dr.mict_parse(s[0]) for s in st.micw_parse(blob)[7]]
    assert {(p[0], p[1], p[7] is not None) for p in parsed} == {(8, 12, True)}
    built = sd.build_lane_operands(parsed + parsed[:1])
    assert built[12] == sd.build_lane_tables(parsed)[10] == 65536 // 8
    abk, aoff, toff = built[10], built[11], built[5]
    assert abk.shape == (4, 128, 4) and list(aoff) == [0, 1, 2, 3, 0]
    for i, p in enumerate(parsed):
        tl = p[1]
        slots = slice(toff[i], toff[i] + (1 << tl))
        got = _bucket_slots(abk[aoff[i]], tl)
        assert _same_slots(got, dr.alias_slot_tables(p[5], tl)[:3])
        assert _same_slots(got, (built[2][slots], built[3][slots], built[4][slots]))
    data = np.minimum(np.random.default_rng(1).geometric(0.02, 3000), 700).astype(np.uint16)
    std = dr.mict_parse(dr.mict_encode(data, lanes=8, table_log=11, max_table_log=11))
    mixed = sd.build_lane_operands([std, parsed[0]])
    assert list(mixed[11]) == [-1, 0] and mixed[10].shape == (1, 128, 4)
    wide = [dr.mict_parse(encode_at(dr, data, 11, 1024))]
    assert list(sd.build_lane_operands(wide)[11]) == [-1]
    assert sd.build_lane_operands(wide)[10].shape == (0, 128, 4)


def test_packing_reads_bucket_tables():
    """A bucket mixing FF 41 and FF 57 strips with its bucket tables: the
    twelve operands decode as the ten through the plain twin; the warp
    form's descriptor names abk and aoff and each team holds a bucket
    table; the block form and a group with none do not; a bucket table
    past abk, or at a tableLog under 7, is refused."""
    rng = np.random.default_rng(9)
    blobs = []
    for tl in (11, 12, 14):
        data = (np.abs(rng.standard_normal(6000)) * 300).astype(np.uint16)
        blobs += [encode_at(dr, data, tl, 32, alias=False), encode_at(dr, data, tl, 32)]
    parsed = [dr.mict_parse(b) for b in blobs]
    built = sd.build_lane_operands(parsed)
    steps = built[12]
    ops = sd.lane_tensors(built[:12], CPU)
    assert list(built[11]) == [-1, 0, -1, 1, -1, 2]
    want = sd.rans_decode_lanes(*ops[:10], steps=steps)
    assert torch.equal(sd.rans_decode_lanes(*ops, steps=steps), want)
    for row, b, p in zip(want.numpy().view(np.uint16), blobs, parsed):
        assert np.array_equal(row[: p[2]], dr.mict_decode_numpy(b))
    pk = sd.LanesPacking([(sd.rans_decode_lanes, ops, {"steps": steps})])
    assert sd._LANE_GROUP_DESC.itemsize == 160
    assert pk.desc["alias"][0] == 1 and pk.desc["ptr"][0][11] == ops[11].data_ptr()
    assert pk.team_bytes == [sd._team_bytes(32, True, 0, 0, True)]
    assert pk.team_bytes[0] == 2048 + 2 * 8 * 64 + 2048
    for plain in (sd.LanesPacking([(sd.rans_decode_lanes, ops[:10], {"steps": steps})]),
                  sd.LanesPacking([(sd.rans_decode_lanes, ops, {"steps": steps})],
                                  warp_lanes=0)):
        assert plain.desc["alias"][0] == 0 and not plain.desc["ptr"][0][10:].any()
    no_alias = (*ops[:11], torch.full_like(ops[11], -1))
    assert sd.LanesPacking([(sd.rans_decode_lanes, no_alias, {"steps": steps})]) \
        .desc["alias"][0] == 0
    assert not sd.fused_strip_fits(512, "pdd", 110592, True, True)
    assert sd.fused_strip_fits(512, "pdd", 110592, True, False)
    for bad, match in ((torch.full_like(ops[11], 3), "aoff"),
                       (torch.tensor([-1, 0, -1, 1, -1, 2], dtype=torch.int32), None)):
        tls = ops[6] if match else torch.full_like(ops[6], 6)
        args = (*ops[:6], tls, *ops[7:11], bad)
        with pytest.raises(ValueError, match="aoff"):
            sd.rans_decode_lanes(*args, steps=steps)
    with pytest.raises(TypeError, match="aoff"):
        sd.rans_decode_lanes(*ops[:10], ops[10], steps=steps)


def _lanes_ops(blobs):
    parsed = [dr.mict_parse(b) for b in blobs]
    built = sd.build_lane_tables(parsed)
    return sd.lane_tensors(built[:10], CPU), built[10], parsed


@pytest.mark.parametrize("lanes", [8, 32, 512])
def test_plain_twin_matches_host_decoder(lanes):
    """Streams of 4-6 tableLogs mixed in one bucket, FF 57 and FF 41 with
    escapes: the symbols up to each count equal ``mict_decode_numpy``."""
    rng = np.random.default_rng(lanes)
    blobs = []
    for i, tl in enumerate((10, 11, 12)):
        data = (np.abs(rng.standard_normal(12000 + 3000 * i)) * 150).astype(np.uint16)
        blobs.append(dr.mict_encode(data, lanes=lanes, table_log=tl, max_table_log=tl))
        blobs.append(dr.mict_encode_alias(data, lanes=lanes, table_log=tl))
    ops, steps, parsed = _lanes_ops(blobs)
    out = sd.rans_decode_lanes(*ops, steps=steps).numpy().view(np.uint16)
    assert out.shape == (len(blobs), steps * lanes)
    for row, b, p in zip(out, blobs, parsed):
        assert np.array_equal(row[: p[2]], dr.mict_decode_numpy(b))
    assert sd.rans_decode_lanes_groups([(sd.rans_decode_lanes, ops, {"steps": steps})])[0] \
        .equal(torch.from_numpy(out.view(np.int16)))


@pytest.mark.parametrize("lanes", [4096, 16384])
def test_plain_twin_wide_lanes(lanes):
    """4 and 16 lanes a thread in the kernel (LANES_MAX lanes at most):
    FF 57 and FF 41 streams at tableLogs 11 and 14 through the plain twin
    equal ``mict_decode_numpy``; one lane more than LANES_MAX is refused."""
    rng = np.random.default_rng(lanes)
    blobs = []
    for tl in (11, 14):
        data = (np.abs(rng.standard_normal(40000)) * 300).astype(np.uint16)
        blobs += [encode_at(dr, data, tl, lanes, alias=False), encode_at(dr, data, tl, lanes)]
    ops, steps, parsed = _lanes_ops(blobs)
    out = sd.rans_decode_lanes(*ops, steps=steps).numpy().view(np.uint16)
    for row, b, p in zip(out, blobs, parsed):
        assert np.array_equal(row[: p[2]], dr.mict_decode_numpy(b))
    pk = sd.LanesPacking([(sd.rans_decode_lanes, ops, {"steps": steps})])
    assert (pk.threads, pk.lpt) == (1024, lanes // 1024)
    with pytest.raises(ValueError, match="lanes"):
        sd.rans_decode_lanes(torch.zeros((1, 2 * sd.LANES_MAX), dtype=torch.int32), *ops[1:],
                             steps=steps)


def test_packing_layout():
    """The two forms' launches (teams a block, shared bytes, threads,
    lanes a thread), table form, descriptors and order."""
    rng = np.random.default_rng(5)
    data = (np.abs(rng.standard_normal(20000)) * 300).astype(np.uint16)
    groups = []
    for lanes, tl in ((2048, 11), (8, 16), (64, 14)):
        ops, steps, _p = _lanes_ops([encode_at(dr, data, tl, lanes, alias=False)] * 2)
        groups.append((sd.rans_decode_lanes, ops, {"steps": steps}))
    pk = sd.LanesPacking(groups)
    assert pk.n_launches == 2 and (pk.threads, pk.lpt) == (1024, 2)
    assert [tuple(r) for r in pk.blocks] == [(0, 0), (0, 1)]  # the block form
    # the warp form: one block of 4 teams, most steps first, a 1 KB ring each
    assert pk.teams.shape == (1, sd.TEAMS, 3)
    assert [tuple(r) for r in pk.teams[0]] == [(1, 0, 0), (1, 1, 1024), (2, 0, 2048),
                                               (2, 1, 3072)]
    assert pk.smem_bytes == 4096 and pk.team_bytes == [0, 1024, 1024]
    assert pk.holds(groups) and not pk.holds(groups[:1])
    narrow = sd.LanesPacking(groups[2:])
    assert narrow.n_launches == 1 and len(narrow.blocks) == 0
    assert [tuple(r) for r in narrow.teams[0]] == [(0, 0, 0), (0, 1, 1024), (-1, -1, -1),
                                                   (-1, -1, -1)]
    wider = sd.LanesPacking(groups[2:], warp_lanes=0)  # every strip in the block form
    assert (wider.n_launches, len(wider.teams), wider.threads, wider.lpt) == (1, 0, 64, 1)
    # a frequency past 16 bits: three tables
    fn, ops, kw = groups[0]
    wide = sd.LanesPacking([(fn, (*ops[:3], ops[3] + 65536, *ops[4:]), kw)])
    W = ops[1].shape[1]
    assert [list(a) for a in pk.desc["arg"][:1]] == [[2048, W, 1, kw["steps"], 0, 0,
                                                      kw["steps"], 1, 0, -(-W // 8) * 8, 8,
                                                      0]]
    assert wide.desc["arg"][0, 4] == 1 and pk.desc["arg"][1, 4] == 0
    with pytest.raises(ValueError, match="steps"):
        sd.LanesPacking([(sd.rans_decode_lanes, groups[0][1], {"steps": 0})])
    bad = list(groups[0][1])
    bad[5] = torch.full_like(bad[5], 1 << 20)  # a table past the flat tables
    with pytest.raises(ValueError, match="toff"):
        sd.rans_decode_lanes(*bad, steps=groups[0][2]["steps"])


# ---------------------------------------------------------------------------
# (c) plans against mic_tpu's host decoder and scan tier
# ---------------------------------------------------------------------------

FREEZE = {"micw": {}, "micw_zzd": {"predictor": "zzd"}, "micw_pdd": {"predictor": "pdd"},
          "micw_alias": {"entropy": "alias"}, "micw_rdense": {"predictor": "zzr"},
          "micw_auto": {"predictor": "auto"}, "micw_auto_alias": {"predictor": "auto",
                                                                  "entropy": "alias"}}


@pytest.mark.parametrize("width", [64, 61])
def test_packing_aligns_row_operands(width):
    """The kernel copies rows of words and escape sides 16 bytes at a time:
    the packing names an operand whose rows start 16-byte aligned as it
    is, and a copy (rows padded to 8 values) of one at an odd storage
    offset or with rows of another length; the copy holds the same
    values."""
    ops, steps, _p = _lanes_ops([encode_at(dr, np.arange(3000, dtype=np.uint16) % 200, 11,
                                           64)] * 2)
    S = ops[0].shape[0]

    def shifted(t, n):  # t's values in rows of n, a contiguous view at storage offset 1
        flat = torch.zeros(S * n + 1, dtype=t.dtype)
        view = flat[1:].view(S, n)
        view[:, :min(n, t.shape[1])] = t[:, :n]
        return view

    words, esides = shifted(ops[1], width), shifted(ops[9], 8)
    assert words.is_contiguous() and words.data_ptr() % 16 and esides.data_ptr() % 16
    for w, e in ((words, esides), (words.clone(), esides.clone())):
        group = (sd.rans_decode_lanes, (ops[0], w, *ops[2:9], e), {"steps": steps})
        pk = sd.LanesPacking([group])
        ptr = pk.desc["ptr"][0]
        assert ptr[1] % 16 == 0 and ptr[9] % 16 == 0
        assert pk.desc["arg"][0][9] == -(-width // 8) * 8 and pk.desc["arg"][0][10] == 8
        held = {t.data_ptr(): t for t in pk._keep}
        for i, t in ((1, w), (9, e)):
            row = held[int(ptr[i])]
            assert torch.equal(row[:, :t.shape[1]], t) and not row[:, t.shape[1]:].any()
            aligned = t.data_ptr() % 16 == 0 and t.shape[1] % 8 == 0
            assert (int(ptr[i]) == t.data_ptr()) == aligned


def _freeze_px():
    """The format-freeze test's 64 x 48 image and its banded 1024 x 96 one."""
    rng = np.random.default_rng(20260816)
    img = (rng.standard_normal((48, 64)).cumsum(axis=1) * 8 + 1000).astype(np.int32)
    px = (img >> 2 << 2).clip(0, 4095).astype(np.uint16).ravel()
    rng = np.random.default_rng(20260817)
    wide = (rng.standard_normal((96, 1024)).cumsum(axis=1) * 8 + 1000).astype(np.int32)
    return px, wide.clip(0, 4095).astype(np.uint16).ravel()


@pytest.mark.parametrize("name", sorted(FREEZE) + ["micw_banded"])
def test_format_freeze_containers_decode(ref, name):
    px, wide = _freeze_px()
    if name == "micw_banded":
        blob, want, wh = ref.st.micw_compress(wide, 1024, 96, int(wide.max()), lanes=64), \
            wide, (1024, 96)
    else:
        blob, want, wh = ref.st.micw_compress(px, 64, 48, int(px.max()), lanes=64,
                                              **FREEZE[name]), px, (64, 48)
    assert st.micw_parse(blob)[6] == 64
    plan = MicwDecodePlan([blob], CPU)
    assert all(k[0] == "scan" and k[1] == 64 for k in plan.buckets)
    ((out, w, h),) = plan.assemble(plan.run())
    assert (w, h) == wh and np.array_equal(out, want)
    host = np.asarray(ref.st.micw_decompress_host(blob)[0]).ravel()
    dev = np.asarray(ref.st.micw_decompress_device(blob)[0]).ravel()
    assert np.array_equal(out, host) and np.array_equal(out, dev)
    scan, sw, sh = micw_decompress_scan(blob, CPU)
    assert (sw, sh) == wh and np.array_equal(scan, want)


@pytest.mark.parametrize("lanes", [8, 32, 512])
def test_lane_counts_decode(ref, lanes):
    px = _smooth(lanes, 64, 96, spikes=0.01)
    mx = int(px.max())
    blobs = [ref.st.micw_compress(px, 96, 64, mx, lanes=lanes, num_strips=2, predictor=p,
                                  entropy=e)
             for p, e in (("auto-fast", "standard"), ("auto", "alias"), ("auto-r", "best"))]
    outs = [o for o, _w, _h in st.micw_decode_many(blobs, CPU)]
    assert all(np.array_equal(o, px) for o in outs)
    for decode in (st.micw_decompress_device, micw_decompress_scan):
        out, w, h = decode(blobs[0], CPU)
        assert (w, h) == (96, 64) and np.array_equal(out, px)
    batch = micw_decode_batch(blobs, CPU)
    want = ref.st.micw_decode_batch(blobs)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(batch, want))
    assert all(np.array_equal(a, px) for a in batch)


def test_alias_fixtures_are_current(ref):
    """The FF 41 fixtures above tableLog 12 equal :func:`alias_reencode`
    of CT_dev today, and mic_tpu decodes them: its host decoder and its
    scan tier (to which its plan sends them); so do the port's scan-tier
    entry points."""
    blob = (TESTDATA / "CT_dev.micw").read_bytes()
    px = _ct()
    for tl, (path, lanes) in ALIAS_FIXTURES.items():
        fixture = path.read_bytes()
        assert fixture == alias_reencode(ref, blob, tl, lanes), path.name
        parsed = [dr.mict_parse(s[0]) for s in st.micw_parse(fixture)[7]]
        assert {(p[0], p[1], p[7] is not None) for p in parsed} == {(lanes, tl, True)}
        assert np.array_equal(np.asarray(ref.st.micw_decompress_host(fixture)[0]).ravel(), px)
        if tl == 13:  # the tiers of mic_tpu's plan decode the others in the mixed test
            assert np.array_equal(np.asarray(ref.st.micw_decompress_device(fixture)[0]).ravel(),
                                  px)
    fixtures = [p.read_bytes() for p, _l in ALIAS_FIXTURES.values()]
    assert all(np.array_equal(o, px) for o in micw_decode_batch(fixtures, CPU))
    out, _w, _h = st.micw_decompress_device(fixtures[-1], CPU)
    assert np.array_equal(out, px)


def test_mixed_plan(ref):
    """128-lane, 64-lane and FF 41 tableLog 13-16 containers in one plan:
    the scan buckets mix families and tableLogs, the others take their
    kernels; every image against its pixels and mic_tpu's plan."""
    ct = _ct()
    px = _smooth(7, 64, 128, spikes=0.02)
    blobs = [(TESTDATA / "CT_dev.micw").read_bytes(),
             ref.st.micw_compress(px, 128, 64, 4095, lanes=64, predictor="auto",
                                  entropy="best"),
             *[p.read_bytes() for p, _l in ALIAS_FIXTURES.values()]]
    plan = MicwDecodePlan(blobs, CPU)
    scan = [k for k in plan.buckets if k[0] == "scan"]
    assert {k[1] for k in scan} == {64, 128} and len(scan) < len(plan.buckets)
    tls = {int(t) for k in scan for t in plan.buckets[k].ops[6]}
    assert {13, 14, 15, 16} <= tls
    decoded = plan.run()
    want = [ct, px] + [ct] * len(ALIAS_FIXTURES)
    assert plan.verify_batch(decoded, want) == 0
    for (out, _w, _h), w in zip(plan.assemble(decoded), want):
        assert np.array_equal(out, w)
    assert np.array_equal(ref.st.micw_decode_many(blobs[2:3])[0][0].ravel(), ct)


def test_mict_decode_device(ref):
    rng = np.random.default_rng(11)
    data = (np.abs(rng.standard_normal(9000)) * 700).astype(np.uint16)
    for blob in (dr.mict_encode(data, lanes=64), dr.mict_encode_alias(data, lanes=32),
                 dr.mict_encode(data, lanes=512, table_log=13, max_table_log=13)):
        got = port_decode.mict_decode_device(blob, CPU)
        assert np.array_equal(got, np.asarray(ref.dec.mict_decode_device(blob)))
        assert np.array_equal(got, data)
        mine, theirs = port_decode.make_plan(blob), ref.dec.make_plan(blob)
        for f in ("lanes", "table_log", "count", "n_steps"):
            assert getattr(mine, f) == getattr(theirs, f)
        for f in ("init_states", "words", "tab_sym", "tab_freq", "tab_bias"):
            assert np.array_equal(getattr(mine, f), getattr(theirs, f))


def test_rle_expand(ref):
    from mic_tpu.ops.rle import RleEncoder, rle_expand

    rng = np.random.default_rng(4)
    for n in (40, 300):
        data = np.repeat(rng.integers(0, 200, n), rng.integers(1, 40, n)).astype(np.uint16)
        enc = RleEncoder(len(data), 1, 255)
        enc.encode(123)
        for v in data.tolist():
            enc.encode(v)
        enc.flush()
        stream = np.array(enc.out, dtype=np.uint16)
        host, _ = rle_expand(stream, 1, 127, None)
        m_pad = len(stream) + 8
        s_pad = np.zeros(m_pad, np.int32)
        s_pad[: len(stream) - 1] = stream[1:]
        for max_out in (len(host) + 64, len(host) // 2):
            want, want_n = ref.pl.rle_expand_device(ref.jnp.asarray(s_pad),
                                                    ref.jnp.int32(len(stream) - 1),
                                                    ref.jnp.int32(127), max_out)
            got, got_n = post.rle_expand(torch.from_numpy(s_pad), len(stream) - 1, 127,
                                         max_out)
            assert int(got_n) == int(want_n) == len(host)
            assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# (d) damaged streams through the scan tier
# ---------------------------------------------------------------------------

KINDS = ["words", "states", "count_up", "count_down", "n_words_down", "escapes", "ncount"]


def _scan_fixture(name):
    if name == "lanes64":
        px = _smooth(9, 96, 128, spikes=0.03)
        return st.micw_compress(px, 128, 96, 4095, lanes=64, predictor="auto", entropy="best")
    if name == "alias8":  # a 128 x 256 crop of CT_dev, 8 lanes, FF 41
        px = np.ascontiguousarray(_ct().reshape(512, 512)[:256, 384:]).ravel()
        return st.micw_compress(px, 128, 256, int(px.max()), lanes=8, predictor="auto-fast",
                                entropy="alias")
    return ALIAS_FIXTURES[14][0].read_bytes()


def _corrupt(blob: bytes, kind: str) -> bytes:
    """``blob`` with its first entropy strip's MICT stream damaged."""
    blob = bytearray(blob)
    mict = st.micw_parse(bytes(blob))[7][0][0]
    at = bytes(blob).find(mict)
    L, _tl, count, _states, words, _norm, _sl, alias = dr.mict_parse(mict)
    n_esc = len(alias[1]) if alias is not None else 0
    words_at = at + len(mict) - 2 * (len(words) + n_esc)
    rng = np.random.default_rng(KINDS.index(kind))
    if kind == "words":
        for o in rng.integers(words_at, words_at + 2 * len(words), 64):
            blob[o] ^= 0xFF
    elif kind == "states":
        for o in rng.integers(words_at - 4 * L, words_at, 32):
            blob[o] ^= 0x5A
    elif kind in ("count_up", "count_down"):
        struct.pack_into("<I", blob, at + 4, count * 2 if kind == "count_up" else count // 2)
    elif kind == "n_words_down":
        struct.pack_into("<I", blob, at + 8, len(words) // 2)
    elif kind == "escapes":
        for o in rng.integers(words_at + 2 * len(words), at + len(mict), 64):
            blob[o] ^= 0xFF
    else:
        blob[at + (18 if alias is not None else 12) + 1] ^= 0x3C
    return bytes(blob)


SCAN_CASES = [(n, k) for n in ("lanes64", "alias_tl14", "alias8") for k in KINDS]


@pytest.mark.parametrize("name,kind", SCAN_CASES)
def test_corrupt_scan_stream_stays_in_bounds(name, kind):
    blob = _corrupt(_scan_fixture(name), kind)
    try:
        plan = MicwDecodePlan([blob], CPU)
    except ValueError:
        return  # rejected at parse or table build
    (out, w, h), = plan.assemble(plan.run())
    assert (w, h) == st.micw_parse(blob)[:2] and out.dtype == np.uint16 and out.size == w * h


def test_corrupt_single_stream(ref):
    """``tests/test_corruption_hardening.py``'s FF 41 cases through the
    port's single-stream decode: a truncated or miscounted escape stream
    raises, as in mic_tpu."""
    rng = np.random.default_rng(2)
    data = (np.abs(rng.standard_normal(5000)) * 800).astype(np.uint16)
    blob = dr.mict_encode_alias(data, lanes=64, table_log=11)
    assert len(dr.mict_parse(blob)[7][1]) > 0
    with pytest.raises(ValueError):
        port_decode.mict_decode_device(blob[:-10], CPU)
    b = bytearray(blob)
    struct.pack_into("<I", b, 12, 0)  # forged n_esc = 0
    with pytest.raises(ValueError, match="escape count"):
        port_decode.mict_decode_device(bytes(b), CPU)
    with pytest.raises(ValueError, match="escape count"):
        ref.dec.mict_decode_device(bytes(b))


# ---------------------------------------------------------------------------
# (e) the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8, 64, 512, 2048, 4096, 16384])
def test_cuda_lanes_kernel_matches_plain(lanes):
    dev = _cuda()
    rng = np.random.default_rng(lanes)
    blobs = []
    for tl in (11, 12, 14, 16):
        data = (np.abs(rng.standard_normal(40000)) * 300).astype(np.uint16)
        blobs += [encode_at(dr, data, tl, lanes, alias=False), encode_at(dr, data, tl, lanes)]
    ops, steps, parsed = _lanes_ops(blobs)
    want = sd.rans_decode_lanes_plain(*ops, steps=steps)
    for row, b, p in zip(want.numpy().view(np.uint16), blobs, parsed):
        assert np.array_equal(row[: p[2]], dr.mict_decode_numpy(b))
    ops_d = tuple(t.to(dev) for t in ops)
    got = sd.rans_decode_lanes(*ops_d, steps=steps)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    (grouped,) = sd.rans_decode_lanes_groups([(sd.rans_decode_lanes, ops_d, {"steps": steps})])
    torch.cuda.synchronize()
    assert torch.equal(grouped.cpu(), want)
    if lanes <= sd.WARP_LANES:  # the block form too
        pk = sd.LanesPacking([(sd.rans_decode_lanes, ops_d, {"steps": steps})], warp_lanes=0)
        (blocked,) = sd._lanes_launch(pk)
        torch.cuda.synchronize()
        assert len(pk.teams) == 0 and torch.equal(blocked.cpu(), want)
    # frequencies past 16 bits: the three-table form (garbage symbols, the same on both)
    wide = list(ops)
    wide[3] = ops[3] + 65536
    assert sd.LanesPacking([(sd.rans_decode_lanes, tuple(t.to(dev) for t in wide),
                             {"steps": steps})]).desc["arg"][0, 4] == 1
    got = sd.rans_decode_lanes(*(t.to(dev) for t in wide), steps=steps)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), sd.rans_decode_lanes_plain(*wide, steps=steps))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8, 32, 64, 512])
def test_cuda_bucket_front_end_matches_plain(lanes):
    """FF 41 strips through their bucket tables at tableLogs 12-17, one
    without escapes, FF 57 strips of tableLogs 12-16 through their slot
    tables in the same bucket: the kernel equals the plain twin (which
    reads the slot tables) bit for bit, through the wrapper and a
    packing.  No stream holds tableLog 17 (its states would leave the
    16-bit renormalisation's range), so that strip is an alias norm at 17
    with random states, words and escapes: garbage both decode alike."""
    dev = _cuda()
    rng = np.random.default_rng(lanes + 3)
    blobs = []
    for tl in (12, 13, 14, 15, 16):
        data = (np.abs(rng.standard_normal(12 * lanes + 3000)) * 300).astype(np.uint16)
        blobs += [encode_at(dr, data, tl, lanes, alias=False), encode_at(dr, data, tl, lanes)]
    blobs.append(encode_at(dr, (np.arange(9000) * 7 % 100).astype(np.uint16), 12, lanes))
    parsed = [dr.mict_parse(b) for b in blobs]
    assert not len(parsed[-1][7][1]) and all(len(p[7][1]) for p in parsed[1:-1:2])
    norm, _al = _alias_layout(data, 17)
    n = len(data)
    parsed.append((lanes, 17, n, rng.integers(1 << 16, 1 << 32, lanes, dtype=np.uint32),
                   rng.integers(0, 1 << 16, n // 2, dtype=np.uint16), norm, len(norm),
                   (int(np.flatnonzero(norm)[-1]), rng.integers(0, 1 << 16, 300, np.uint16))))
    built = sd.build_lane_operands(parsed)
    assert list(built[11] >= 0) == [p[7] is not None for p in parsed]
    ops = sd.lane_tensors(built[:12], CPU)
    steps = built[12]
    want = sd.rans_decode_lanes_plain(*ops, steps=steps)
    for row, b, p in zip(want.numpy().view(np.uint16), blobs, parsed):
        assert np.array_equal(row[: p[2]], dr.mict_decode_numpy(b))
    ops_d = tuple(t.to(dev) for t in ops)
    got = sd.rans_decode_lanes(*ops_d, steps=steps)
    pk = sd.LanesPacking([(sd.rans_decode_lanes, ops_d, {"steps": steps})])
    (grouped,) = sd._lanes_launch(pk)
    torch.cuda.synchronize()
    assert pk.desc["alias"][0] == 1
    assert torch.equal(got.cpu(), want) and torch.equal(grouped.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind", SCAN_CASES)
def test_cuda_corrupt_scan_stream_matches_cpu(name, kind):
    """``test_corrupt_scan_stream_stays_in_bounds``' damaged containers on
    the card (bucket tables for their FF 41 strips): every bucket equals
    the CPU plan's (the plain twin) bit for bit."""
    dev = _cuda()
    blob = _corrupt(_scan_fixture(name), kind)
    try:
        want = MicwDecodePlan([blob], CPU).run()
    except ValueError:
        return  # rejected at parse or table build, on every device alike
    plan = MicwDecodePlan([blob], dev)
    got = plan.run()
    torch.cuda.synchronize()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
def test_cuda_plans_match_cpu():
    dev = _cuda()
    blobs = [_scan_fixture("lanes64")] + [p.read_bytes() for p, _l in ALIAS_FIXTURES.values()]
    blobs += [_corrupt(b, k) for b in blobs[:2] for k in KINDS]
    for blob in blobs:
        try:
            want = MicwDecodePlan([blob], CPU).run()
        except ValueError:
            continue
        plan = MicwDecodePlan([blob], dev)
        got = plan.run()
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), k
        # the scan buckets symbols out in the block form, against the plain twin
        groups = [(fn, ops, {"steps": kw["steps"]}) for fn, ops, kw in plan._scan_groups]
        blocked = sd._lanes_launch(sd.LanesPacking(groups, warp_lanes=0))
        plain = sd.rans_decode_lanes_groups_plain(
            [(fn, tuple(t.cpu() for t in ops), kw) for fn, ops, kw in groups])
        torch.cuda.synchronize()
        assert all(torch.equal(b.cpu(), w) for b, w in zip(blocked, plain))
    px = _ct()
    outs = micw_decode_batch([p.read_bytes() for p, _l in ALIAS_FIXTURES.values()], dev)
    assert all(np.array_equal(o, px) for o in outs)
