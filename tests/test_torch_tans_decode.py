"""The port's tANS decode of the reference formats against mic_tpu.

* the host copies pinned to their originals: ``build_dtable``,
  ``build_rans_dec_table``, ``ReverseBitReader``, the host decoders of
  ``ops/fse_codec.py`` and ``ops/rans.py``, ``fse_parse_header``,
  ``_pack_dtable`` and ``build_tans_batch`` (all six operands, steps,
  tableLog and alphabet sweep);
* ``tans_decode`` (its plain version, on CPU tensors) against
  ``tans_decode_pallas`` in interpret mode on whole output arrays, on the
  same operands: N = 2, 4 and 8, both coders (FF 84 tANS and FF 08 rANS
  tables), tableLogs 5-13 mixed in a launch, alphabet sweeps 1-32, counts
  that are not multiples of N;
* ``fse_decompress_device_batch`` against ``mic_tpu``'s, blob for blob,
  with the routing cases (1-state, tableLog 14-16, a group with more than
  4096 symbols) counted in its stats;
* damaged streams (a truncated body, a zero last byte, an over-claimed
  count, a count of 0): the port raises where ``mic_tpu`` raises and
  otherwise returns what ``mic_tpu``'s kernel returns, the plain version
  reading only inside its arrays (torch's gathers check every index).

* per-stream ``sizes`` (each stream's own table and alphabet words): the
  plain version with them equals the call without them and the Pallas
  kernel, on groups that mix tableLogs 5-13; ``tans_decode_groups`` (its
  plain twin) equals the per-group calls; the block packing of the merged
  launch (``pack_blocks``, ``TansPacking``) covers every stream once,
  stays inside the pool and is longest first.

Streams are made with numpy from seeds, at an exact tableLog through
``mic_tpu``'s own encoder parts.  Tolerance 0.  The ``cuda`` tests hold
the kernel against its plain version on the card; they need no jax:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tans_decode.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mic_tpu_torch.ops import bitio, fse, fse_codec, rans
from mic_tpu_torch.tpu import tans_decode as td
from mic_tpu_torch.tpu.rans_decode import to_device

CPU = torch.device("cpu")
MAGIC = {2: b"\xff\x02", 4: b"\xff\x04", 8: b"\xff\x84"}


@pytest.fixture(scope="module")
def ref():
    """mic_tpu's host coders and tANS kernel (needs jax)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from mic_tpu.ops import bitio as rbitio
    from mic_tpu.ops import fse as rfse
    from mic_tpu.ops import fse_codec as rcodec
    from mic_tpu.ops import rans as rrans
    from mic_tpu.tpu import pallas_tans

    return SimpleNamespace(jnp=jnp, bitio=rbitio, fse=rfse, codec=rcodec, rans=rrans,
                           pt=pallas_tans)


def _skewed(rng, n, nsym, p=1.2):
    w = 1.0 / np.arange(1, nsym + 1) ** p
    data = rng.choice(nsym, size=n, p=w / w.sum()).astype(np.uint16)
    data[: min(n, nsym)] = np.arange(min(n, nsym))  # every symbol present
    return rng.permutation(data)


def _blob(ref, data, n, tl, coder="tans"):
    """A reference-format blob of ``data`` at exactly tableLog ``tl``:
    FF 02/04/84 through mic_tpu's tANS encoder, FF 08 through its rANS
    tables (the loop of ``rans_compress_8state`` without its tableLog
    choice)."""
    counts, _mx, sl = ref.fse.histogram(data)
    norm = ref.fse.normalize_count(counts, len(data), tl, sl)
    hdr = ref.fse.write_count(norm, sl, tl)
    if coder == "tans":
        bits = ref.codec._encode_bitstream(data, norm, sl, tl, n)
        return MAGIC[n] + len(data).to_bytes(4, "little") + hdr + bits
    freq, bias, k0, thr = (a.tolist() for a in ref.rans.build_rans_enc_table(norm, sl, tl))
    states, values, widths = [0] * 8, [], []
    for i in range(len(data) - 1, -1, -1):
        s, lane = int(data[i]), i & 7
        x_l = states[lane] + (1 << tl)
        k = k0[s] - (x_l < thr[s])
        values.append(x_l)
        widths.append(k)
        states[lane] = bias[s] + (x_l >> k) - freq[s]
    for lane in range(7, -1, -1):
        values.append(states[lane])
        widths.append(tl)
    w = ref.bitio.BitWriterLSB()
    w.values, w.widths = values, widths
    return b"\xff\x08" + len(data).to_bytes(4, "little") + hdr + w.close()


def _parsed(blob):
    _n, count, body, _coder = td.fse_parse_header(blob)
    norm, sl, tl, used = fse.read_ncount(body)
    return count, norm, sl, tl, body[used:]


def _port_symbols(ops, steps, n, tl):
    out = td.tans_decode(*to_device(ops, CPU), steps=steps, n_states=n, table_log=tl)
    assert out.dtype == torch.int16
    return out.numpy().view(np.uint16)


# (N, coder, [(count, alphabet, tableLog), ...]): tableLogs 5-13 mixed in
# a launch, alphabet sweeps 1 to 32, counts off multiples of N.
CASES = {
    "n2_tans": (2, "tans", [(301, 12, 5), (1001, 100, 9), (777, 300, 11)]),
    "n4_tans": (4, "tans", [(3001, 1500, 12), (2999, 700, 13), (99, 9, 6)]),
    "n8_tans": (8, "tans", [(6001, 4000, 13), (93, 20, 7)]),
    "n8_rans": (8, "rans", [(501, 30, 6), (2001, 200, 10), (4003, 900, 13)]),
    "n2_tl8_one_tile": (2, "tans", [(255, 40, 8), (13, 3, 5)]),
}


def _case_blobs(ref, name):
    n, coder, streams = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    datas = [_skewed(rng, c, a) for c, a, _tl in streams]
    return n, coder, datas, [_blob(ref, d, n, tl, coder) for d, (_c, _a, tl) in zip(datas, streams)]


# ---------------------------------------------------------------------------
# Host copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table_log", [5, 8, 11, 13, 15])
def test_build_dtable_and_rans_table_match(ref, table_log):
    rng = np.random.default_rng(table_log)
    for nsym in (3, 40, 700):
        if nsym > (1 << table_log):
            continue
        data = _skewed(rng, 5000, nsym)
        counts, _mx, sl = ref.fse.histogram(data)
        norm = ref.fse.normalize_count(counts, len(data), table_log, sl)
        for got, want in zip(fse.build_dtable(norm, sl, table_log),
                             ref.fse.build_dtable(norm, sl, table_log)):
            assert np.array_equal(got, want) and np.asarray(got).dtype == np.asarray(want).dtype
        for got, want in zip(rans.build_rans_dec_table(norm, sl, table_log),
                             ref.rans.build_rans_dec_table(norm, sl, table_log)):
            assert np.array_equal(got, want) and got.dtype == want.dtype


def test_reverse_bit_reader_matches(ref):
    rng = np.random.default_rng(5)
    for n_bytes in (1, 2, 7, 64):
        data = bytes(rng.integers(0, 256, n_bytes, dtype=np.uint8))
        data = data[:-1] + bytes([data[-1] | 1])
        a, b = bitio.ReverseBitReader(data), ref.bitio.ReverseBitReader(data)
        assert a.total_bits == b.total_bits
        for nb in rng.integers(0, 17, 40).tolist():  # reads past bit 0 included
            assert a.get_bits(nb) == b.get_bits(nb) and a.pos == b.pos
    for bad in (b"", b"\x05\x00"):
        with pytest.raises(ValueError):
            bitio.ReverseBitReader(bad)
        with pytest.raises(ValueError):
            ref.bitio.ReverseBitReader(bad)


def test_host_decoders_match(ref):
    """The host route: every magic through ``fse_decompress_auto`` and the
    per-format decoders, against mic_tpu's."""
    rng = np.random.default_rng(9)
    data = _skewed(rng, 3000, 60)
    blobs = [ref.codec.fse_compress(data), ref.codec.fse_compress_2state(data),
             ref.codec.fse_compress_4state(data), ref.codec.fse_compress_8state(data),
             ref.rans.rans_compress_8state(data)]
    for blob in blobs:
        got = fse_codec.fse_decompress_auto(blob)
        assert got.dtype == np.uint16 and np.array_equal(got, data)
        assert np.array_equal(got, ref.codec.fse_decompress_auto(blob))
    assert np.array_equal(rans.rans_decompress_8state(blobs[4]), data)
    assert np.array_equal(fse_codec.fse_decompress_8state(blobs[3]), data)
    assert (fse_codec.MAGIC_2STATE, fse_codec.MAGIC_4STATE, fse_codec.MAGIC_8STATE_FSE,
            fse_codec.MAGIC_8STATE_RANS) == (ref.codec.MAGIC_2STATE, ref.codec.MAGIC_4STATE,
                                             ref.codec.MAGIC_8STATE_FSE,
                                             ref.codec.MAGIC_8STATE_RANS)
    with pytest.raises(ValueError):
        fse_codec.fse_decompress_4state(blobs[2], limit=10)
    with pytest.raises(ValueError):
        rans.rans_decompress_8state(blobs[3])


@pytest.mark.parametrize("name", sorted(CASES))
def test_parse_pack_and_batch_match(ref, name):
    """fse_parse_header, _pack_dtable and build_tans_batch: every operand
    array for array, steps, tableLog and sweep."""
    n, coder, _datas, blobs = _case_blobs(ref, name)
    for blob in blobs:
        assert td.fse_parse_header(blob) == ref.pt.fse_parse_header(blob)
    parsed = [_parsed(b) for b in blobs]
    for count, norm, sl, tl, _bits in parsed:
        got, want = td._pack_dtable(norm, sl, tl, coder), ref.pt._pack_dtable(norm, sl, tl, coder)
        assert all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want))
    for min_steps in (0, 1000):
        got = td.build_tans_batch(parsed, n, min_steps=min_steps, coder=coder)
        want = ref.pt.build_tans_batch(parsed, n, min_steps=min_steps, coder=coder)
        assert got[1:] == want[1:]
        for g, w in zip(got[0], want[0]):
            assert g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w)


def test_pack_dtable_caps_match(ref):
    rng = np.random.default_rng(3)
    wide = _skewed(rng, 20000, 5000)  # more than 4096 distinct symbols
    counts, _mx, sl = ref.fse.histogram(wide)
    norm = ref.fse.normalize_count(counts, len(wide), 13, sl)
    assert td._pack_dtable(norm, sl, 13) is None and ref.pt._pack_dtable(norm, sl, 13) is None
    norm14 = ref.fse.normalize_count(counts, len(wide), 14, sl)
    assert td._pack_dtable(norm14, sl, 14) is None
    assert td.build_tans_batch([(1, norm14, sl, 14, b"\x01")], 2) is None
    assert (td.TANS_MAX_TABLE_LOG, td.TANS_MAX_ALPHABET) == (
        ref.pt.TANS_MAX_TABLE_LOG, ref.pt.TANS_MAX_ALPHABET)


# ---------------------------------------------------------------------------
# Plain version against the Pallas kernel, whole output arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_whole_array(ref, name):
    n, coder, datas, blobs = _case_blobs(ref, name)
    ops, steps, tl, asweep = ref.pt.build_tans_batch([_parsed(b) for b in blobs], n, coder=coder)
    want = np.asarray(ref.pt.tans_decode_pallas(
        *(ref.jnp.asarray(a) for a in ops), steps=steps, n_streams=len(blobs), n_states=n,
        table_log=tl, asweep=asweep))
    got = _port_symbols(ops, steps, n, tl)
    assert got.shape == want.shape and np.array_equal(got, want)
    flat = got.reshape(len(blobs), -1)
    for row, data in zip(flat, datas):
        assert np.array_equal(row[: len(data)], data) and not row[len(data):].any()


def test_wrapper_checks_operands():
    ops = [np.zeros((2, 128), np.uint32), np.zeros((2, 128), np.int32),
           np.zeros((2, 128), np.uint32), np.zeros((2, 256), np.uint32),
           np.zeros((2, 128), np.uint32), np.zeros((2, 3, 128), np.uint32)]
    t = to_device(ops, CPU)
    out = td.tans_decode(*t, steps=128, n_states=8, table_log=8)
    assert out.shape == (2, 8, 128) and not out.any()
    for kw, exc in ((dict(steps=128, n_states=3, table_log=8), ValueError),
                    (dict(steps=100, n_states=8, table_log=8), ValueError),
                    (dict(steps=128, n_states=8, table_log=14), ValueError),
                    (dict(steps=128, n_states=8, table_log=9), ValueError)):
        with pytest.raises(exc):
            td.tans_decode(*t, **kw)
    with pytest.raises(TypeError):
        td.tans_decode(t[0].to(torch.int64), *t[1:], steps=128, n_states=8, table_log=8)


# ---------------------------------------------------------------------------
# The batch function, routing, damaged streams
# ---------------------------------------------------------------------------


def test_batch_matches_reference_with_routing(ref):
    """A batch that takes every route: 1-state, tableLog 14 and 16, a
    4-state group at tableLog 13 in which one stream has over 4096
    symbols (both go to the host, as in mic_tpu), and kernel streams of
    both coders and all N, one of them in the same batch twice."""
    rng = np.random.default_rng(11)
    small = _skewed(rng, 1200, 50)
    wide = _skewed(rng, 20000, 5000)
    blobs = [ref.codec.fse_compress(small),                      # 0: 1-state
             _blob(ref, _skewed(rng, 9000, 3000), 2, 14),        # 1: tl 14
             _blob(ref, _skewed(rng, 9000, 300), 8, 16),         # 2: tl 16
             _blob(ref, wide, 4, 13),                            # 3: > 4096 symbols
             _blob(ref, _skewed(rng, 19001, 900), 4, 13),        # 4: its group-mate
             _blob(ref, small, 2, 9),                            # 5: kernel
             _blob(ref, small, 8, 10, "rans"),                   # 6: kernel, FF 08
             _blob(ref, _skewed(rng, 2001, 70), 8, 11),          # 7: kernel, FF 84
             _blob(ref, small, 2, 9)]                            # 8: kernel
    stats = {}
    got = td.fse_decompress_device_batch(blobs, CPU, stats=stats)
    want = ref.pt.fse_decompress_device_batch(blobs)
    for g, w, b in zip(got, want, blobs):
        assert g.dtype == np.uint16 and np.array_equal(g, w)
        assert np.array_equal(g, ref.codec.fse_decompress_auto(b))
    assert stats["host"] == [0, 1, 2, 3, 4]
    assert stats["kernel"] == 4 and stats["streams"] == 9
    assert stats["groups"] == 3  # (tans, 2), (rans, 8), (tans, 8)
    assert stats["symbols"] == 3 * 1200 + 2001
    assert td.fse_decompress_device_batch([], CPU) == []


def test_plan_merges_routing_groups_longest_first(ref):
    """Routing groups of one coder and N (here four: tableLogs 9 and 12,
    step buckets 256, 512 and 2048) share one launch whose operands are
    build_tans_batch's for all their streams, longest first; the plain
    version's rows past every count are 0, however many there are."""
    rng = np.random.default_rng(17)
    datas = [_skewed(rng, 700, 30), _skewed(rng, 5000, 200), _skewed(rng, 1500, 30),
             _skewed(rng, 300, 900)]
    blobs = [_blob(ref, d, 4, tl) for d, tl in zip(datas, (9, 12, 9, 12))]
    plan = td.TansDecodePlan(blobs, CPU)
    assert plan.stats["groups"] == 1 and plan.stats["host"] == []
    idx, counts, ops, kw = plan.groups[0]
    assert idx == [1, 2, 0, 3] and counts == [5000, 1500, 700, 300]
    want, steps, tl, _asweep = td.build_tans_batch([_parsed(blobs[i]) for i in idx], 4,
                                                   min_steps=8 * 32)
    assert kw == dict(steps=steps, n_states=4, table_log=tl)
    for g, w in zip(ops, to_device(want, CPU)):
        assert torch.equal(g, w)
    out = td.tans_decode_plain(*ops, **kw)
    longer = td.tans_decode_plain(*ops, **dict(kw, steps=steps + 8 * 32))
    assert torch.equal(longer[:, : out.shape[1]], out) and not longer[:, out.shape[1]:].any()
    for row, d in zip(out.reshape(4, -1).numpy().view(np.uint16), (datas[i] for i in idx)):
        assert np.array_equal(row[: len(d)], d) and not row[len(d):].any()


def test_damaged_streams_like_reference(ref):
    """Truncated body, over-claimed count and a count of 0 decode (to the
    same garbage as mic_tpu's kernel: reads below bit 0 take the window
    clamp, not zeros); a zero last byte and a header cut short raise on
    both sides."""
    rng = np.random.default_rng(21)
    data = _skewed(rng, 900, 40)
    blob = _blob(ref, data, 8, 9)
    count, *_rest, bits = _parsed(blob)
    head = blob[: len(blob) - len(bits)]
    over = blob[:2] + (count + 60).to_bytes(4, "little") + blob[6:]
    zero = blob[:2] + (0).to_bytes(4, "little") + blob[6:]
    truncated = head + bits[len(bits) // 2:]
    batch = [truncated, over, zero, blob]
    got = td.fse_decompress_device_batch(batch, CPU)
    want = ref.pt.fse_decompress_device_batch(batch)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert len(got[2]) == 0 and np.array_equal(got[3], data)
    assert np.array_equal(got[1][:count], data)
    for bad in (head + bits[:-1] + b"\x00", blob[:9]):
        with pytest.raises(ValueError):
            ref.pt.fse_decompress_device_batch([bad])
        with pytest.raises(ValueError):
            td.fse_decompress_device_batch([bad], CPU)


# ---------------------------------------------------------------------------
# Per-stream sizes, merged groups, block packing
# ---------------------------------------------------------------------------

# N -> (coder, [(count, alphabet, tableLog), ...]): tableLogs 5-13 in one group.
MIXED = {
    2: ("tans", [(701, 20, 5), (333, 60, 7), (900, 150, 9), (515, 400, 11), (1203, 900, 13)]),
    4: ("tans", [(1301, 2500, 13), (410, 25, 6), (777, 90, 8), (999, 300, 10), (64, 500, 12)]),
    8: ("rans", [(2001, 1100, 13), (95, 17, 5), (1500, 130, 9), (640, 700, 12), (801, 40, 7)]),
}


def _mixed_group(ref, n):
    """(datas, numpy operands, host sizes, kwargs) of MIXED[n]."""
    coder, streams = MIXED[n]
    rng = np.random.default_rng(100 + n)
    datas = [_skewed(rng, c, a) for c, a, _tl in streams]
    parsed = [_parsed(_blob(ref, d, n, tl, coder)) for d, (_c, _a, tl) in zip(datas, streams)]
    ops, steps, tl, _asweep = td.build_tans_batch(parsed, n, coder=coder)
    sizes = td._own_sizes([p[3] for p in parsed], ops[4])
    return datas, ops, sizes, dict(steps=steps, n_states=n, table_log=tl)


@pytest.mark.parametrize("n", sorted(MIXED))
def test_plain_with_sizes_matches_pallas(ref, n):
    """The plain version with each stream's own table and alphabet sizes
    equals the call without them and the Pallas kernel, whole arrays."""
    datas, ops, sizes, kw = _mixed_group(ref, n)
    streams = MIXED[n][1]
    assert sizes[:, 0].tolist() == [max(128, 1 << tl) for _c, _a, tl in streams]
    assert len(set(sizes[:, 0].tolist())) > 1 and (sizes[:, 1] % 128 == 0).all()
    for own_asz, d in zip(sizes[:, 1].tolist(), datas):  # its own alphabet, rounded up to 128
        assert 0 <= own_asz - len(np.unique(d)) < 128
    t = to_device(ops, CPU)
    without = td.tans_decode(*t, **kw)
    with_sizes = td.tans_decode(*t, sizes=torch.from_numpy(sizes), **kw)
    assert torch.equal(with_sizes, without)
    want = np.asarray(ref.pt.tans_decode_pallas(
        *(ref.jnp.asarray(a) for a in ops), steps=kw["steps"], n_streams=len(datas),
        n_states=n, table_log=kw["table_log"], asweep=ops[4].shape[1] // 128))
    got = with_sizes.numpy().view(np.uint16)
    assert got.shape == want.shape and np.array_equal(got, want)
    for row, d in zip(got.reshape(len(datas), -1), datas):
        assert np.array_equal(row[: len(d)], d) and not row[len(d):].any()


def test_sizes_cut_the_tables_like_zero_padding():
    """A read at or past a stream's own sizes gives 0 whatever the operand
    holds there: sizes over junk-padded tables decode like zero-padded
    ones."""
    rng = np.random.default_rng(8)
    R, n, tl = 6, 4, 9
    own = np.array([[128, 128], [256, 128], [512, 256], [512, 384], [128, 256], [256, 384]],
                   np.int32)
    init = np.zeros((R, 128), np.uint32)
    init[:, :n] = rng.integers(0, 700, (R, n))  # some states past the own table
    pos = np.repeat(rng.integers(100, 9000, (R, 1)), 128, axis=1).astype(np.int32)
    cnt = np.repeat(rng.integers(1, 900, (R, 1)), 128, axis=1).astype(np.uint32)
    tpk = ((rng.integers(0, 500, (R, 512)).astype(np.uint32) << 19)
           | (rng.integers(0, 512, (R, 512)).astype(np.uint32) << 5)
           | rng.integers(0, 10, (R, 512)).astype(np.uint32))
    alpha = rng.integers(1, 65536, (R, 384)).astype(np.uint32)
    words = rng.integers(0, 2**32, (R, 5, 128), dtype=np.uint64).astype(np.uint32)
    zt, za = tpk.copy(), alpha.copy()
    for i, (a, b) in enumerate(own):
        zt[i, a:], za[i, b:] = 0, 0
    kw = dict(steps=8 * 32, n_states=n, table_log=tl)
    junk = td.tans_decode(*to_device((init, pos, cnt, tpk, alpha, words), CPU),
                          sizes=torch.from_numpy(own), **kw)
    zero = td.tans_decode(*to_device((init, pos, cnt, zt, za, words), CPU), **kw)
    assert torch.equal(junk, zero) and junk.any()
    assert not torch.equal(junk, td.tans_decode(
        *to_device((init, pos, cnt, tpk, alpha, words), CPU), **kw))


@pytest.mark.parametrize("bad", [[[64, 128]], [[128, 0]], [[200, 128]], [[1024, 128]],
                                 [[128, 512]]])
def test_sizes_are_checked(bad):
    ops = to_device([np.zeros((1, 128), np.uint32), np.zeros((1, 128), np.int32),
                     np.zeros((1, 128), np.uint32), np.zeros((1, 512), np.uint32),
                     np.zeros((1, 256), np.uint32), np.zeros((1, 3, 128), np.uint32)], CPU)
    kw = dict(steps=128, n_states=8, table_log=9)
    ok = torch.tensor([[512, 256]], dtype=torch.int32)
    assert not td.tans_decode(*ops, sizes=ok, **kw).any()
    with pytest.raises(ValueError):
        td.tans_decode(*ops, sizes=torch.tensor(bad, dtype=torch.int32), **kw)
    with pytest.raises(TypeError):
        td.tans_decode(*ops, sizes=ok.to(torch.int64), **kw)
    with pytest.raises(ValueError):
        td.TansPacking([(ops, torch.tensor(bad, dtype=torch.int32), kw)])


def test_groups_plain_matches_per_group_calls(ref):
    """tans_decode_groups over groups of different coders and N equals the
    per-group calls (on the CPU it is its plain twin and launches
    nothing)."""
    groups, want = [], []
    for n in sorted(MIXED):
        _datas, ops, sizes, kw = _mixed_group(ref, n)
        t = to_device(ops, CPU)
        groups.append((t, torch.from_numpy(sizes), kw))
        want.append(td.tans_decode(*t, **kw))
    before = td.tans_decode_groups.launches
    got = td.tans_decode_groups(groups)
    assert td.tans_decode_groups.launches == before
    assert len(got) == 3 and all(torch.equal(g, w) for g, w in zip(got, want))
    plain = td.tans_decode_groups_plain(groups)
    assert all(torch.equal(g, w) for g, w in zip(plain, want))
    assert td.tans_decode_groups([]) == []
    # The same groups as a packing: every stream in one block, its own sizes.
    packing = td.TansPacking(groups)
    assert (packing.warps, packing.pool_bytes) == (4, td.MAX_POOL_BYTES)
    assert packing.holds(groups) and not packing.holds(groups[:2])
    assert [len(b[1]) for b in packing.blocks] == [4, 4, 4, 1, 1, 1]  # a group a block
    first = [(g, b[0]) for g, b, _o in packing.blocks]  # chains weighed by STEP_NS
    assert first[0] == (2, 0) and td.STEP_NS[2] < td.STEP_NS[4] < td.STEP_NS[8]
    for bad in (dict(warps=9), dict(pool_bytes=td.MAX_POOL_BYTES + 16), dict(pool_bytes=1000)):
        with pytest.raises(ValueError):
            td.TansPacking(groups, **bad)
    assert sorted((g, s) for g, streams, _o in packing.blocks for s in streams) == [
        (g, s) for g in range(3) for s in range(5)]
    assert packing.out_shapes == [tuple(w.shape) for w in want]


PACK_CASES = [(seed, pool, warps) for seed in (0, 1, 2)
              for pool, warps in ((57344, 8), (232448, 8), (76800, 4), (52000, 1))]


@pytest.mark.parametrize("seed,pool,warps", PACK_CASES)
def test_pack_blocks_covers_fits_and_orders(seed, pool, warps):
    rng = np.random.default_rng(seed)
    needs, chains = [], []
    for _g in range(4):
        r = int(rng.integers(0, 60))
        sizes = np.stack([1 << rng.integers(7, 14, r), 128 * rng.integers(1, 33, r)], axis=1)
        needs.append(td.stream_bytes(sizes))
        chains.append(rng.integers(0, 40000, r))
    blocks = td.pack_blocks(needs, chains, pool, warps)
    seen = sorted((g, s) for g, streams, _o in blocks for s in streams)
    assert seen == [(g, s) for g in range(4) for s in range(len(needs[g]))]  # exactly once
    firsts = []
    for g, streams, offs in blocks:
        assert 1 <= len(streams) <= warps
        ends = [o + int(needs[g][s]) for s, o in zip(streams, offs)]
        assert offs[0] == 0 and offs[1:] == ends[:-1] and ends[-1] <= pool
        assert all(o % 16 == 0 for o in offs)
        c = [int(chains[g][s]) for s in streams]
        assert c == sorted(c, reverse=True)
        firsts.append(c[0])
    assert firsts == sorted(firsts, reverse=True)  # longest chain first over the grid
    for g in range(4):  # a group's streams are taken in chain order, block after block
        order = [int(chains[g][s]) for gg, streams, _o in blocks if gg == g for s in streams]
        assert order == sorted(order, reverse=True)
    with pytest.raises(ValueError):
        td.pack_blocks([np.array([pool + 16])], [np.array([1])], pool, warps)


def test_plan_is_one_launch_with_own_sizes(ref):
    """The plan's groups go to tans_decode_groups together; its sizes are
    each stream's own, in the launch order."""
    rng = np.random.default_rng(23)
    specs = [(2, 9, 50, "tans"), (2, 12, 600, "tans"), (8, 13, 2000, "rans"),
             (8, 6, 20, "rans"), (4, 11, 300, "tans")]
    datas = [_skewed(rng, 400 + 300 * i, a) for i, (_n, _tl, a, _c) in enumerate(specs)]
    blobs = [_blob(ref, d, n, tl, c) for d, (n, tl, _a, c) in zip(datas, specs)]
    plan = td.TansDecodePlan(blobs, CPU)
    assert plan.stats["groups"] == 3 and plan.stats["launches"] == 1
    assert plan.stats["table_logs"] == {6: 1, 9: 1, 11: 1, 12: 1, 13: 1}
    assert plan.packing is None  # built for the card only
    for (idx, _counts, ops, _kw), sizes in zip(plan.groups, plan.sizes):
        assert sizes.dtype == torch.int32 and sizes.shape == (len(idx), 2)
        for bi, (own_ts, own_asz) in zip(idx, sizes.tolist()):
            assert own_ts == max(128, 1 << specs[bi][1])
            assert 0 <= own_asz - len(np.unique(datas[bi])) < 128
        assert ops[3].shape[1] >= int(sizes[:, 0].max())
    outs = plan.run()
    assert len(outs) == 3
    for got, d in zip(plan.results(outs), datas):
        assert np.array_equal(got, d)
    assert td.TansDecodePlan([], CPU).stats["launches"] == 0


DAMAGE = ["words", "states", "count_down", "front_cut", "table_bytes"]


@pytest.mark.parametrize("kind", DAMAGE)
@pytest.mark.parametrize("n", [2, 8])
def test_damaged_kinds_like_reference(ref, n, kind):
    """Flipped stream words, flipped final bytes (the initial states), a
    halved count, a body that lost its front and flipped table-header
    bytes: the port raises where mic_tpu raises and otherwise decodes to
    mic_tpu's kernel's symbols."""
    rng = np.random.default_rng(31 + n)
    data = _skewed(rng, 1100, 60)
    blob = bytearray(_blob(ref, data, n, 9))
    count, *_rest, bits = _parsed(bytes(blob))
    at = len(blob) - len(bits)
    variants = []
    if kind == "words":
        for o in rng.integers(at, len(blob) - 8, 24):
            blob[o] ^= 0xFF
    elif kind == "states":
        for o in range(len(blob) - 5, len(blob) - 1):
            blob[o] ^= 0x5A
    elif kind == "count_down":
        blob[2:6] = (count // 2).to_bytes(4, "little")
    elif kind == "front_cut":
        del blob[at:at + len(bits) // 4]
    else:
        for o in range(6, at):  # every byte of the normalized-count header in turn
            v = bytearray(blob)
            v[o] ^= 0x3C
            variants.append(bytes(v))
    for damaged in variants or [bytes(blob)]:
        try:
            want = ref.pt.fse_decompress_device_batch([damaged, damaged])
        except ValueError:
            with pytest.raises(ValueError):
                td.fse_decompress_device_batch([damaged, damaged], CPU)
            continue
        got = td.fse_decompress_device_batch([damaged, damaged], CPU)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# The CUDA kernel on the card
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 8])
def test_cuda_kernel_matches_plain(n):
    """Kernel == plain on operands with mixed tableLogs and counts, and on
    damaged operands (counts past the stream, a cursor past the words)."""
    dev = _need_cuda()
    rng = np.random.default_rng(n)
    R, tl, ts = 24, 13, 1 << 13
    init = np.zeros((R, 128), np.uint32)
    init[:, :n] = rng.integers(0, ts, (R, n))
    pos = np.repeat(rng.integers(-50, 40000, (R, 1)), 128, axis=1).astype(np.int32)
    cnt = np.repeat(rng.integers(0, 5000, (R, 1)), 128, axis=1).astype(np.uint32)
    tpk = ((rng.integers(0, 4096, (R, ts)).astype(np.uint32) << 19)
           | (rng.integers(0, ts, (R, ts)).astype(np.uint32) << 5)
           | rng.integers(0, 14, (R, ts)).astype(np.uint32))
    alpha = rng.integers(0, 65536, (R, 4096)).astype(np.uint32)
    words = rng.integers(0, 2**32, (R, 12, 128), dtype=np.uint64).astype(np.uint32)
    steps = 8 * (128 // n) * 5
    ops = to_device((init, pos, cnt, tpk, alpha, words), dev)
    before = td.tans_decode.launches
    got = td.tans_decode(*ops, steps=steps, n_states=n, table_log=tl)
    torch.cuda.synchronize()
    assert td.tans_decode.launches == before + 1
    want = td.tans_decode_plain(*ops, steps=steps, n_states=n, table_log=tl)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_batch_matches_host():
    """The in-repo MR fixtures' payloads (FF 84 and FF 08, tableLog 13),
    every one through the kernel route, against the host decoder."""
    from pathlib import Path

    from mic_tpu_torch.utils.io import read_mic1

    dev = _need_cuda()
    root = Path(__file__).resolve().parent.parent / "web" / "testdata"
    blobs = [read_mic1((root / f"MR_{k}.mic").read_bytes())[3] for k in ("2s", "8s", "rans8")]
    stats = {}
    got = td.fse_decompress_device_batch(blobs * 3, dev, stats=stats)
    assert stats["host"] == [] and stats["kernel"] == 9
    for g, b in zip(got, blobs * 3):
        assert np.array_equal(g, fse_codec.fse_decompress_auto(b))


def _random_group(rng, n, R, dev, wild):
    """Operands of R streams with their own tableLogs 7-13 and alphabets
    (tables zero past them), cursors from below bit 0 to past the words and
    counts past the steps; ``wild`` streams hold nb up to 31 (a fifth vote,
    and lanes that spread over more words than the register window)."""
    tl, ts, asz = 13, 1 << 13, 4096
    own = np.stack([1 << rng.integers(7, 14, R), 128 * rng.integers(1, 33, R)], axis=1)
    own[0] = (ts, asz)
    init = np.zeros((R, 128), np.uint32)
    init[:, :n] = rng.integers(0, ts, (R, n))
    pos = np.repeat(rng.integers(-50, 60000, (R, 1)), 128, axis=1).astype(np.int32)
    cnt = np.repeat(rng.integers(0, 6000, (R, 1)), 128, axis=1).astype(np.uint32)
    nb = rng.integers(0, 14, (R, ts))
    nb[wild] = rng.integers(0, 32, (len(wild), ts))
    tpk = ((rng.integers(0, 4096, (R, ts)).astype(np.uint32) << 19)
           | (rng.integers(0, ts, (R, ts)).astype(np.uint32) << 5) | nb.astype(np.uint32))
    alpha = rng.integers(0, 65536, (R, asz)).astype(np.uint32)
    for i, (a, b) in enumerate(own):
        tpk[i, a:], alpha[i, b:] = 0, 0
    words = rng.integers(0, 2**32, (R, 12, 128), dtype=np.uint64).astype(np.uint32)
    ops = to_device((init, pos, cnt, tpk, alpha, words), dev)
    kw = dict(steps=8 * (128 // n) * 5, n_states=n, table_log=tl)
    return ops, torch.from_numpy(own.astype(np.int32)).to(dev), kw


@pytest.mark.cuda
def test_cuda_groups_match_plain():
    """The merged launch over groups of N = 2, 4 and 8 with per-stream
    sizes equals the plain twin, with one launch; the same operands without
    sizes, group by group, give the same."""
    dev = _need_cuda()
    rng = np.random.default_rng(41)
    groups = [_random_group(rng, n, 19, dev, wild=[3, 7, 11]) for n in (2, 4, 8, 8)]
    before = td.tans_decode_groups.launches, td.tans_decode.launches
    got = td.tans_decode_groups(groups)
    torch.cuda.synchronize()
    assert (td.tans_decode_groups.launches, td.tans_decode.launches) == (before[0] + 1, before[1])
    want = td.tans_decode_groups_plain(groups)
    for g, w, (ops, _sizes, kw) in zip(got, want, groups):
        assert torch.equal(g, w)
        assert torch.equal(td.tans_decode(*ops, **kw), w)
    packing = td.TansPacking(groups, warps=3, pool_bytes=120000)
    again = td.tans_decode_groups(groups, packing)
    assert all(torch.equal(g, w) for g, w in zip(again, want))
    with pytest.raises(ValueError):
        td.tans_decode_groups(groups[:2], packing)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["truncated", "over_claimed", "words", "states",
                                  "table_bytes"])
def test_cuda_damaged_streams_match_plain(kind):
    """Damaged copies of the in-repo MR payloads (N = 4, 8 and FF 08)
    through the plan on the card: the merged kernel equals its plain twin
    on the same operands, and the CPU plan's symbols."""
    from pathlib import Path

    from mic_tpu_torch.utils.io import read_mic1

    dev = _need_cuda()
    root = Path(__file__).resolve().parent.parent / "web" / "testdata"
    rng = np.random.default_rng(DAMAGE.index(kind) if kind in DAMAGE else 9)
    batch = []
    for k in ("4s", "8s", "rans8"):
        blob = bytearray(read_mic1((root / f"MR_{k}.mic").read_bytes())[3])
        count, *_rest, bits = _parsed(bytes(blob))
        at = len(blob) - len(bits)
        if kind == "truncated":
            del blob[at:at + len(bits) // 2]
        elif kind == "over_claimed":
            blob[2:6] = (count + 4000).to_bytes(4, "little")
        elif kind == "words":
            for o in rng.integers(at, len(blob) - 8, 64):
                blob[o] ^= 0xFF
        elif kind == "states":
            for o in range(len(blob) - 5, len(blob) - 1):
                blob[o] ^= 0x5A
        else:
            blob[at - 3] ^= 0x3C
        batch.append(bytes(blob))
    try:
        plan = td.TansDecodePlan(batch, dev)
    except ValueError:
        with pytest.raises(ValueError):
            td.TansDecodePlan(batch, CPU)
        return
    before = td.tans_decode_groups.launches
    outs = plan.run()
    torch.cuda.synchronize()
    assert td.tans_decode_groups.launches == before + plan.stats["launches"]
    want = td.tans_decode_groups_plain(plan._launch_groups)
    assert all(torch.equal(g, w) for g, w in zip(outs, want))
    cpu = td.TansDecodePlan(batch, CPU)
    for g, w in zip(plan.results(outs), cpu.results(cpu.run())):
        assert np.array_equal(g, w)
