"""The port's multi-device tier (``mic_tpu_torch/tpu/mesh.py``) and dry run
(``mic_tpu_torch/dryrun.py``) against ``mic_tpu``.

* Each of the seven sharded wrappers on ``[cpu] * 2`` and ``[cpu] * 4``
  (the kernels' plain twins), tolerance 0 on whole arrays: against
  ``mic_tpu.tpu.mesh``'s wrapper on the conftest's 8-device virtual CPU
  mesh (Pallas in interpret mode), on the same seeded numpy operands, at
  the shapes of ``tests/test_mesh.py`` (the zzd and FF 41 decodes, the FF
  57 encode) and on 4-state and FF 08 streams of 512 symbols (the tANS
  decode); elsewhere (the scan-tier, r-mode and FF 41 encode wrappers)
  against the port's unsharded call, which the other ``test_torch_*``
  files pin to the Pallas kernels.
* The mesh's refusals: a leading dimension that does not divide, and no
  silent CPU mesh without CUDA.
* ``dryrun_multichip`` on four CPU devices; ``entry`` against
  ``__graft_entry__.entry()``'s step; the dry run's reference-format
  encoders (copies in ``mic_tpu_torch/ops``) byte for byte against
  ``mic_tpu.ops``.

The ``cuda`` test runs the dry run on the card over ``[cuda:0] * 2``;
it needs no jax (``python -m pytest --noconftest -p no:cacheprovider -m
cuda tests/test_torch_mesh.py``).
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mic_tpu_torch import dryrun
from mic_tpu_torch.ops import fse_codec, rans
from mic_tpu_torch.tpu import mesh as M
from mic_tpu_torch.tpu import rans_decode as rd
from mic_tpu_torch.tpu import rans_encode as renc
from mic_tpu_torch.tpu import scan_decode as sd

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SHARDS = [2, 4]


@pytest.fixture(scope="module")
def ref():
    """mic_tpu's mesh, operand code and encoders on the 8-device CPU mesh."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from mic_tpu.ops import fse, fse_codec as rcodec, rans as rrans
    from mic_tpu.tpu import device_rans, mesh, pallas_enc, pallas_rans, pallas_tans, strips

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return SimpleNamespace(jnp=jnp, mesh=mesh, m8=mesh.make_strip_mesh(jax.devices()[:8]),
                           fse=fse, codec=rcodec, rans=rrans, dr=device_rans, enc=pallas_enc,
                           pr=pallas_rans, tans=pallas_tans, st=strips)


def _mesh(n):
    return M.make_strip_mesh([CPU] * n)


def _u16(t) -> np.ndarray:
    return t.numpy().view(np.uint16) if t.dtype == torch.int16 else t.numpy().view(np.uint32)


def _jax(ref, fn, ops, **kw):
    out = fn(ref.m8, *map(ref.jnp.asarray, ops), **kw)
    return tuple(map(np.asarray, out)) if isinstance(out, tuple) else np.asarray(out)


@pytest.fixture(scope="module")
def zzd_case(ref):
    """test_mesh.py::test_sharded_pallas_decode's operands and mic_tpu's output."""
    rng = np.random.default_rng(5)
    img = (rng.standard_normal((64, 128)).cumsum(axis=1) * 9 + 700).astype(np.int32)
    px = img.clip(0, 4095).astype(np.uint16).ravel()
    blob = ref.st.micw_compress(px, 128, 64, int(px.max()), num_strips=8, lanes=128,
                                predictor="zzd")
    width, _h, ns, _sh, *_, strips = ref.st.micw_parse(blob)
    parsed = [ref.dr.mict_parse(st[0]) for st in strips]
    tl = max(p[1] for p in parsed)
    init, tpk, alpha, words, mask, shift, _c, steps, asweep = \
        ref.pr.build_packed_tables(parsed, tl)
    ops = (init, tpk, alpha, words, mask, shift, np.full((ns, 128), width // 128, np.uint32))
    kw = dict(steps=steps, n_strips=1, table_log=tl, asweep=asweep)
    return ops, kw, _jax(ref, ref.mesh.decode_strips_sharded_pallas, ops, **kw)


@pytest.mark.parametrize("n", SHARDS)
def test_decode_strips_sharded_pallas_matches_mic_tpu(zzd_case, n):
    ops, kw, want = zzd_case
    shards = M.decode_strips_sharded_pallas(_mesh(n), *ops, **kw)
    assert len(shards) == n and all(s.shape[0] == 8 // n for s in shards)
    assert np.array_equal(_u16(M.gather(shards, CPU)), want)


@pytest.fixture(scope="module")
def alias_case(ref):
    """test_mesh.py::test_sharded_alias_decode's streams (tableLogs 8 and 10
    mixed) and mic_tpu's output."""
    rng = np.random.default_rng(9)
    shapes = [(2048, 400, 9), (8192, 60, 10)]
    parsed = []
    for s in range(8):
        n, alpha, req = shapes[s % 2]
        d = np.minimum(rng.geometric(2.0 / alpha, n), alpha).astype(np.uint16)
        parsed.append(ref.dr.mict_parse(ref.dr.mict_encode_alias(d, table_log=req)))
    assert len({p[1] for p in parsed}) > 1
    built = ref.pr.build_alias_bucket_tables(parsed)
    ops = built[:9] + (np.zeros((8, 128), np.uint32),)
    kw = dict(steps=built[10], vdd_ws=0, fused=False)
    return ops, kw, _jax(ref, ref.mesh.decode_alias_sharded, ops, **kw)


@pytest.mark.parametrize("n", SHARDS)
def test_decode_alias_sharded_matches_mic_tpu(alias_case, n):
    ops, kw, want = alias_case
    assert np.array_equal(_u16(M.gather(M.decode_alias_sharded(_mesh(n), *ops, **kw), CPU)),
                          want)


def _enc_case(ref, S, n_sym, seed, alias):
    """test_mesh.py's encode operands (``alias``: its FF 41 form)."""
    rng = np.random.default_rng(seed)
    specs, rks, tls, runs = [], [], [], []
    for _s in range(S):
        syms = (rng.standard_normal(n_sym) * 12 + 80).clip(0, 511).astype(np.uint16)
        counts, _mc, sl = ref.fse.histogram(syms)
        tl = min(ref.fse.optimal_table_log(11, n_sym, sl), 11)
        norm = ref.fse.normalize_count(counts, n_sym, tl, sl)
        _sym, _fs, _bs, freq, cumul = ref.dr.device_tables(norm, tl)
        present = np.nonzero(freq)[0]
        lut = np.zeros(65536, np.uint16)
        lut[present] = np.arange(len(present), dtype=np.uint16)
        specs.append((freq[present].astype(np.uint32), cumul[present].astype(np.uint32)))
        rks.append(lut[syms])
        tls.append(tl)
        if alias:
            runs.append(ref.dr.alias_construct(norm, tl)["enc_runs"])
    steps = (-(-n_sym // 128) + 7) // 8 * 8
    te1, te2, asweep = ref.enc.build_enc_tables(specs, 11)
    rk = np.zeros((S, steps * 128), np.uint16)
    for i, r in enumerate(rks):
        rk[i, :n_sym] = r
    ops = [rk.reshape(S, steps, 128), te1, te2, np.full((S, 128), n_sym, np.uint32),
           np.repeat(np.array(tls, np.uint32)[:, None], 128, axis=1)]
    if alias:
        ar1 = np.full((S, 256), 0xFFFFFFFF, np.uint32)
        ar2 = np.zeros((S, 256), np.uint32)
        for i, (st, ba) in enumerate(runs):
            ar1[i, : len(st)] = st
            ar2[i, : len(ba)] = ba
        ops[3:3] = [ar1.reshape(S, 2, 128), ar2.reshape(S, 2, 128)]
    return tuple(ops), dict(steps=steps, asweep=asweep)


@pytest.fixture(scope="module")
def encode_case(ref):
    """test_mesh.py::test_sharded_encode's operands and mic_tpu's output."""
    ops, kw = _enc_case(ref, 8, 4096, 21, alias=False)
    return ops, kw, _jax(ref, ref.mesh.encode_strips_sharded, ops, **kw)


@pytest.mark.parametrize("n", SHARDS)
def test_encode_strips_sharded_matches_mic_tpu(encode_case, n):
    ops, kw, want = encode_case
    shards = M.encode_strips_sharded(_mesh(n), *ops, **kw)
    assert len(shards) == n and all(len(s) == 3 for s in shards)
    got = M.gather(shards, CPU)
    for g, w in zip(got, want):
        assert np.array_equal(_u16(g), w)


@pytest.fixture(scope="module", params=["tans", "rans"])
def tans_case(ref, request):
    """8 streams of 512 symbols, 4-state tANS or FF 08 8-state rANS, and
    mic_tpu's sharded decode."""
    coder = request.param
    rng = np.random.default_rng(11)
    p = 1.0 / np.arange(1, 33) ** 1.2
    compress, n_states = ((ref.codec.fse_compress_4state, 4) if coder == "tans"
                          else (ref.rans.rans_compress_8state, 8))
    datas = [rng.choice(32, size=512, p=p / p.sum()).astype(np.uint16) for _ in range(8)]
    parsed = []
    for d in datas:
        _n, count, body, _coder = ref.tans.fse_parse_header(compress(d))
        norm, symbol_len, tl, consumed = ref.fse.read_ncount(body)
        parsed.append((count, norm, symbol_len, tl, body[consumed:]))
    ops, steps, tlm, asweep = ref.tans.build_tans_batch(parsed, n_states, coder=coder)
    kw = dict(steps=steps, n_states=n_states, table_log=tlm, asweep=asweep)
    return ops, kw, _jax(ref, ref.mesh.decode_tans_sharded, ops, **kw), datas


@pytest.mark.parametrize("n", SHARDS)
def test_decode_tans_sharded_matches_mic_tpu(tans_case, n):
    ops, kw, want, datas = tans_case
    got = _u16(M.gather(M.decode_tans_sharded(_mesh(n), *ops, **kw), CPU))
    assert np.array_equal(got, want)
    for s, d in enumerate(datas):
        assert np.array_equal(got[s].reshape(-1)[: d.size], d)


@pytest.mark.parametrize("n", SHARDS)
def test_decode_strips_sharded_matches_unsharded(n):
    """The scan tier's step (64-lane zzd strips, the graft entry's batch
    at 8 strips) against ``decode_strip_batch`` on whole arrays."""
    arrays, static, img = dryrun.tiny_micw_batch(num_strips=8)
    got = M.gather(M.decode_strips_sharded(_mesh(n), *arrays, **static), CPU)
    assert torch.equal(got, sd.decode_strip_batch(*arrays, **static, device=CPU))
    assert np.array_equal(_u16(got).reshape(-1)[: img.size], img.ravel())


@pytest.fixture(scope="module")
def rle_case(ref):
    """The graft entry's r-mode operands at 8 strips (zzr, long runs)."""
    rng = np.random.default_rng(6)
    img = np.zeros((64, 128), np.uint16)
    img[:, :80] = 321
    img[:, 80:112] = rng.integers(318, 324, (64, 32)).astype(np.uint16)
    px = img.ravel()
    blob = ref.st.micw_compress(px, 128, 64, int(px.max()), num_strips=8, lanes=128,
                                predictor="zzr")
    width, _h, ns, sh, *_, strips = ref.st.micw_parse(blob)
    parsed = [ref.dr.mict_parse(st[0]) for st in strips]
    tl = max(max(p[1] for p in parsed), 7)
    init, tpk, alpha, words, mask, shift, _c, steps, asweep = \
        ref.pr.build_packed_tables(parsed, tl, min_steps=8)
    runs = [np.repeat(np.array([[st[k]] for st in strips], np.int32), 128, axis=1)
            for k in (3, 4)]
    ops = (init, tpk, alpha, words, mask, shift,
           np.full((ns, 128), width // 128, np.uint32), *runs)
    out_rows = ref.st._pow2_at_least(-(-max(st[2] for st in strips) // 128), 8)
    return ops, dict(steps=steps, out_rows=out_rows, maxr=512), tl, asweep, px, sh * width


@pytest.mark.parametrize("n", SHARDS)
def test_decode_rle_sharded_matches_unsharded(rle_case, n):
    ops, kw, tl, asweep, px, row_px = rle_case
    got = M.gather(M.decode_rle_sharded(_mesh(n), *ops, **kw, n_strips=8 // n, table_log=tl,
                                        asweep=asweep, mid_count=rd.MID_DIRECT, vdd_ws=0), CPU)
    assert torch.equal(got, rd.rans_decode_rle(*rd.to_device(ops, CPU), **kw))
    rows = _u16(got).reshape(8, -1)
    for s in range(8):
        assert np.array_equal(rows[s][:row_px], px[s * row_px:(s + 1) * row_px])
    with pytest.raises(ValueError, match="mid_count"):
        M.decode_rle_sharded(_mesh(n), *ops, **kw, mid_count=255)


@pytest.mark.parametrize("n", SHARDS)
def test_encode_alias_sharded_matches_unsharded(ref, n):
    """test_mesh.py::test_sharded_alias_encode's shape (8 streams of 1024
    symbols, FF 41 run tables), with the port's per-stream widths."""
    ops, kw = _enc_case(ref, 8, 1024, 21, alias=True)
    widths = np.array([int(np.count_nonzero(row)) for row in ops[1]], np.int32)
    got = M.gather(M.encode_alias_sharded(_mesh(n), *ops, **kw), CPU)
    dev = [torch.from_numpy(a.view(np.int16 if a.dtype == np.uint16 else np.int32))
           for a in ops]
    want = renc.rans_encode_alias(*dev, steps=kw["steps"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got_w = M.gather(M.encode_alias_sharded(_mesh(n), *ops, **kw, widths=widths), CPU)
    want_w = renc.rans_encode_alias(*dev, steps=kw["steps"], widths=torch.from_numpy(widths))
    assert all(torch.equal(g, w) for g, w in zip(got_w, want_w))


def test_leading_dimension_must_divide(zzd_case):
    ops, kw, _want = zzd_case
    with pytest.raises(ValueError, match="does not divide"):
        M.decode_strips_sharded_pallas(_mesh(3), *ops, **kw)
    with pytest.raises(TypeError, match="unexpected keyword"):
        M.decode_strips_sharded_pallas(_mesh(2), *ops, **kw, fused=False)


def test_make_strip_mesh_takes_no_silent_cpu():
    if torch.cuda.is_available():
        assert M.make_strip_mesh() == tuple(torch.device("cuda", i)
                                            for i in range(torch.cuda.device_count()))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.make_strip_mesh(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.dryrun_multichip(2)
    assert M.make_strip_mesh(["cpu", "cpu"]) == (CPU, CPU)
    with pytest.raises(ValueError):
        M.make_strip_mesh([])


def test_dryrun_multichip_on_four_cpu_devices(capsys):
    dryrun.dryrun_multichip(4, devices=[CPU] * 4)
    assert "dryrun_multichip OK: 4-device mesh" in capsys.readouterr().out


def test_entry_matches_graft_entry(ref):
    """``dryrun.entry(cpu)`` against ``__graft_entry__.entry()``: the same
    operands, and its step's output on whole arrays."""
    import jax

    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as ge

    jfn, jargs = ge.entry()
    fn, args = dryrun.entry(CPU)
    assert len(args) == len(jargs) == 11
    for a, b in zip(args, jargs):
        assert np.array_equal(np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64))
    got = fn(*args)
    want = np.asarray(jax.jit(jfn)(*jargs))
    assert got.shape == want.shape and np.array_equal(_u16(got), want)


@pytest.mark.parametrize("size", [300, 512, 5000])
def test_reference_encoders_match_mic_tpu(ref, size):
    """``fse_compress_4state`` and ``rans_compress_8state`` (copied for the
    dry run) write ``mic_tpu``'s bytes."""
    rng = np.random.default_rng(size)
    p = 1.0 / np.arange(1, 41) ** 1.1
    data = rng.choice(40, size=size, p=p / p.sum()).astype(np.uint16)
    assert fse_codec.fse_compress_4state(data) == ref.codec.fse_compress_4state(data)
    assert rans.rans_compress_8state(data) == ref.rans.rans_compress_8state(data)
    for tl in (5, 9, 12):
        assert (fse_codec.fse_compress_4state(data, tl)
                == ref.codec.fse_compress_4state(data, tl))
    for bad in (np.zeros(64, np.uint16), np.arange(3, dtype=np.uint16)):
        for port, orig in ((fse_codec.fse_compress_4state, ref.codec.fse_compress_4state),
                           (rans.rans_compress_8state, ref.rans.rans_compress_8state)):
            with pytest.raises(Exception) as e_port:
                port(bad)
            with pytest.raises(Exception) as e_orig:
                orig(bad)
            assert type(e_port.value).__name__ == type(e_orig.value).__name__


@pytest.mark.cuda
def test_cuda_dryrun_multichip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dryrun.dryrun_multichip(2, devices=[torch.device("cuda", 0)] * 2)


def test_build_strip_batch_matches_mic_tpu(ref):
    """The copy of ``build_strip_batch`` (``decode_strips_sharded``'s
    operands): FF 41 strips with and without escapes beside FF 57 ones at
    one tableLog, padded to a mesh of 8."""
    rng = np.random.default_rng(3)
    streams = [np.minimum(rng.geometric(0.02, n), 700).astype(np.uint16) for n in (3000, 2900)]
    blobs = [ref.dr.mict_encode_alias(streams[0], lanes=32, table_log=11, max_table_log=11),
             ref.dr.mict_encode_alias(streams[1] % 200, lanes=32, table_log=11),
             ref.dr.mict_encode(streams[1], lanes=32, table_log=11)]
    parsed = [ref.dr.mict_parse(b) for b in blobs]
    (tl,) = {p[1] for p in parsed}
    assert parsed[0][7] is not None and len(parsed[0][7][1]) and parsed[2][7] is None
    entries = [(b, 1, 10 + i, 3 * i, i, 2) for i, b in enumerate(blobs)]
    got, meta = sd.build_strip_batch(parsed, entries, tl, pad_strips_to=8)
    want, want_meta = ref.st.build_strip_batch(parsed, entries, tl, pad_strips_to=8)
    assert meta == want_meta and len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
