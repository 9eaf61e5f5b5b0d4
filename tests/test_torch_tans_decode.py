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
