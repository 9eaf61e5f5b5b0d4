"""The port's counterpart of ``__graft_entry__.py``: the flagship decode
step with its example arguments, and the multi-device dry run.

* :func:`tiny_micw_batch` — the graft entry's tiny MICW strip batch (a
  smooth 64 x 32 image as zzd strips of 64 lanes), made with the port's
  host encoder, in ``build_strip_batch``'s operands and static arguments;
* :func:`entry` — ``(fn, example_args)``: ``scan_decode.decode_strip_batch``
  bound to that batch's statics and a device;
* :func:`dryrun_multichip` — every path of the graft entry's dry run over
  a mesh of ``n_devices`` devices (``tpu/mesh.py``), built with the port's
  own encoders and operand code, each sharded call held against the unsharded
  port call on whole arrays and against the pixels or symbols it encodes,
  and its kernel's launches counted (one a CUDA shard).  Raises on any
  mismatch; prints the devices it used and one summary line.

Run it on the card with ``python -c "from mic_tpu_torch.dryrun import
dryrun_multichip; dryrun_multichip(8)"``, or on the CPU (the kernels'
plain twins) with ``dryrun_multichip(4, devices=[torch.device("cpu")] * 4)``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .ops.fse import histogram, normalize_count, optimal_table_log, read_ncount
from .ops.fse_codec import fse_compress_4state
from .ops.predictors import delta_params
from .ops.rans import rans_compress_8state
from .tpu import mesh as M
from .tpu import rans_decode as rd
from .tpu import rans_encode as renc
from .tpu import scan_decode as sd
from .tpu import tans_decode as td
from .tpu.device_rans import alias_construct, device_tables, mict_encode_alias, mict_parse
from .tpu.strips import _pow2_at_least, micw_compress, micw_parse

__all__ = ["tiny_micw_batch", "entry", "dryrun_multichip"]

# The launch counters a sharded call moves: one launch a CUDA shard.
_COUNTERS = {
    "direct": lambda: rd.rans_decode_direct_groups.launches,
    "rle": lambda: rd.rans_decode_rle_groups.launches,
    "tans": lambda: td.tans_decode_groups.launches,
    "lanes": lambda: sd.rans_decode_lanes_groups.launches,
    "encode": lambda: renc.rans_encode.launches,
    "encode_alias": lambda: renc.rans_encode_alias.launches,
}


def tiny_micw_batch(num_strips: int, lanes: int = 64, h: int = 32, w: int = 64):
    """``__graft_entry__._tiny_micw_batch``: a deterministic smooth h x w
    image as ``num_strips`` zzd strips of ``lanes`` lanes, in the 11
    operands of ``scan_decode.build_strip_batch`` (padded with replicas
    of strip 0 to ``num_strips``) and the static arguments of
    ``decode_strip_batch_impl``; returns (operands, statics, image)."""
    rng = np.random.default_rng(0)
    img = (rng.standard_normal((h, w)).cumsum(axis=1) * 8 + 512).astype(np.int32)
    img = (img >> 2 << 2).clip(0, 1023).astype(np.uint16)
    blob = micw_compress(img.ravel(), w, h, int(img.max()), num_strips=num_strips, lanes=lanes,
                         predictor="zzd")
    width, _h, _n, strip_h, max_value, pred, _l, strips = micw_parse(blob)
    parsed = [mict_parse(b) for b, *_ in strips]
    tl = max(p[1] for p in parsed)
    if any(p[1] != tl for p in parsed):
        raise AssertionError("the tiny batch must share its tableLog")
    arrays, meta = sd.build_strip_batch(parsed, strips, tl, pad_strips_to=num_strips)
    delim = int(delta_params(max_value)[1])
    static = dict(table_log=tl, n_steps=meta["n_steps"], width=width, strip_h=strip_h,
                  max_runs=meta["max_runs"], max_tokens=meta["max_tokens"],
                  mid_count=(1 << (delim.bit_length() - 1)) - 1, delim=delim, predictor=pred)
    return arrays, static, img


def entry(device):
    """``__graft_entry__.entry()`` on ``device``: (fn, example_args), the
    scan tier's decode step over the tiny 4-strip batch; ``fn(*example_args)``
    returns int16 [4, width * strip_h] (bit-views of the u16 pixels)."""
    arrays, static, _img = tiny_micw_batch(num_strips=4)
    return partial(sd.decode_strip_batch, **static, device=torch.device(device)), arrays


def _sharded(name: str, counter: str, mesh, call):
    """``call()``'s shards gathered on the CPU, after checking that it
    launched its kernel once for each CUDA device of ``mesh``."""
    before = _COUNTERS[counter]()
    shards = call()
    grew = _COUNTERS[counter]() - before
    want = sum(d.type == "cuda" for d in mesh)
    if grew != want:
        raise AssertionError(f"{name}: {grew} kernel launches for {want} CUDA shards")
    return M.gather(shards, "cpu")


def _same(name: str, got, want) -> None:
    """Sharded == unsharded, whole arrays (tuples element by element)."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, x in zip(got, want):
        if g.shape != x.shape or not torch.equal(g, x.cpu()):
            raise AssertionError(f"{name}: sharded output != the unsharded port call")


def _strips_equal(name: str, out: torch.Tensor, px: np.ndarray, n_rows: int,
                  row_px: int) -> None:
    """Each of the first ``n_rows`` output rows starts with its strip's
    ``row_px`` pixels of ``px``."""
    got = out.numpy().view(np.uint16).reshape(out.shape[0], -1)
    for s in range(n_rows):
        want = px[s * row_px:(s + 1) * row_px]
        if not np.array_equal(got[s][: want.size], want):
            raise AssertionError(f"{name}: mismatch in strip {s}")


def _ws(n: int, width: int) -> np.ndarray:
    return np.full((n, 128), width // 128, np.uint32)


def _smooth(rng, h: int, w: int) -> np.ndarray:
    img = (rng.standard_normal((h, w)).cumsum(axis=1) * 9 + 700).astype(np.int32)
    return img.clip(0, 4095).astype(np.uint16).ravel()


def _scan(mesh, n: int) -> None:
    """The strip-sharded scan-tier decode against the image."""
    arrays, static, img = tiny_micw_batch(num_strips=n)
    got = _sharded("decode_strips_sharded", "lanes", mesh,
                   lambda: M.decode_strips_sharded(mesh, *arrays, **static))
    _same("decode_strips_sharded", got, sd.decode_strip_batch(*arrays, **static,
                                                              device=mesh[0]))
    h, w = img.shape
    sh = static["strip_h"]
    for s in range(-(-h // sh)):
        rows = img[s * sh:(s + 1) * sh].ravel()
        if not np.array_equal(got[s].numpy().view(np.uint16)[: rows.size], rows):
            raise AssertionError(f"decode_strips_sharded: mismatch in strip {s}")


def _zzd(mesh, n: int) -> None:
    """The fused FF 57 zzd decode, one strip a device."""
    px = _smooth(np.random.default_rng(5), 8 * n, 128)
    blob = micw_compress(px, 128, 8 * n, int(px.max()), num_strips=n, lanes=128, predictor="zzd")
    width, _h, ns, sh, *_, strips = micw_parse(blob)
    parsed = [mict_parse(st[0]) for st in strips]
    tl = max(p[1] for p in parsed)
    init, tpk, alpha, words, mask, shift, _c, steps, asweep = rd.build_packed_tables(parsed, tl)
    ops = (init, tpk, alpha, words, mask, shift, _ws(ns, width))
    got = _sharded("decode_strips_sharded_pallas", "direct", mesh,
                   lambda: M.decode_strips_sharded_pallas(mesh, *ops, steps=steps, n_strips=1,
                                                          table_log=tl, asweep=asweep))
    _same("decode_strips_sharded_pallas", got,
          rd.rans_decode_zzd(*rd.to_device(ops, mesh[0]), steps=steps))
    _strips_equal("decode_strips_sharded_pallas", got, px, ns, sh * width)


def _rmode(mesh, n: int) -> None:
    """The r-mode device encodes (zzr; auto-r + best), byte-identical to
    the host container, then the sharded r-mode decode of the device's
    zzr bytes."""
    rng = np.random.default_rng(6)
    rh, rw = 8 * n, 128
    rimg = np.zeros((rh, rw), np.uint16)
    rimg[:, :80] = 321  # long runs: real SoA-RLE streams
    rimg[:, 80:112] = rng.integers(318, 324, (rh, 32)).astype(np.uint16)
    rpx = rimg.ravel()
    image = [(rpx, rw, rh, int(rpx.max()), n)]
    rblob = renc.micw_compress_device_many(image, mesh[0], predictor="zzr")[0]
    if rblob != micw_compress(rpx, rw, rh, int(rpx.max()), num_strips=n, lanes=128,
                              predictor="zzr"):
        raise AssertionError("device r-mode encode != host container")
    best = renc.micw_compress_device_many(image, mesh[0], predictor="auto-r", entropy="best")[0]
    if best != micw_compress(rpx, rw, rh, int(rpx.max()), num_strips=n, lanes=128,
                             predictor="auto-r", entropy="best"):
        raise AssertionError("device auto-r+best encode != host container")
    width, _h, ns, sh, *_, strips = micw_parse(rblob)
    parsed = [mict_parse(st[0]) for st in strips]
    tl = max(max(p[1] for p in parsed), 7)  # the packed tables' floor
    init, tpk, alpha, words, mask, shift, _c, steps, asweep = rd.build_packed_tables(
        parsed, tl, min_steps=8)
    maxr = 512  # maxr / 128 = 4 <= the 8-step floor
    out_rows = _pow2_at_least(-(-max(st[2] for st in strips) // 128), 8)
    runs = [np.repeat(np.array([[st[k]] for st in strips], np.int32), 128, axis=1)
            for k in (3, 4)]
    ops = (init, tpk, alpha, words, mask, shift, _ws(ns, width), *runs)
    got = _sharded("decode_rle_sharded", "rle", mesh,
                   lambda: M.decode_rle_sharded(mesh, *ops, steps=steps, out_rows=out_rows,
                                                table_log=tl, asweep=asweep, maxr=maxr,
                                                mid_count=rd.MID_DIRECT, vdd_ws=0))
    _same("decode_rle_sharded", got, rd.rans_decode_rle(*rd.to_device(ops, mesh[0]),
                                                        steps=steps, out_rows=out_rows,
                                                        maxr=maxr))
    _strips_equal("decode_rle_sharded", got, rpx, ns, sh * width)


def _alias(mesh, n: int) -> None:
    """The FF 41 decode, symbols out, tableLogs 9-11 mixed in one call."""
    rng = np.random.default_rng(7)
    datas = [np.minimum(rng.geometric(0.07, 2048), 400).astype(np.uint16) for _ in range(n)]
    parsed = [mict_parse(mict_encode_alias(d, table_log=9 + s % 3))
              for s, d in enumerate(datas)]
    init, w0, w1, w2, words, mask, shift, escv, esides, _c, steps = \
        rd.build_alias_bucket_tables(parsed)
    ops = (init, w0, w1, w2, words, mask, shift, escv, esides, np.zeros((n, 128), np.uint32))
    got = _sharded("decode_alias_sharded", "direct", mesh,
                   lambda: M.decode_alias_sharded(mesh, *ops, steps=steps, vdd_ws=0,
                                                  fused=False))
    _same("decode_alias_sharded", got, rd.rans_decode_alias(*rd.to_device(ops, mesh[0]),
                                                            steps=steps, fused=False))
    for s, d in enumerate(datas):
        if not np.array_equal(got[s].numpy().view(np.uint16).reshape(-1)[: d.size], d):
            raise AssertionError(f"decode_alias_sharded: mismatch in stream {s}")


def _tans(mesh, n: int) -> None:
    """The reference formats' streams: 4-state tANS, then FF 08 8-state
    rANS, 512 symbols each."""
    rng = np.random.default_rng(11)
    p = 1.0 / np.arange(1, 33) ** 1.2
    for compress, n_states, coder in ((fse_compress_4state, 4, "tans"),
                                      (rans_compress_8state, 8, "rans")):
        datas = [rng.choice(32, size=512, p=p / p.sum()).astype(np.uint16) for _ in range(n)]
        parsed = []
        for d in datas:
            n_st, count, body, got_coder = td.fse_parse_header(compress(d))
            if (n_st, got_coder) != (n_states, coder):
                raise AssertionError(f"{coder} stream parsed as {n_st} states, {got_coder}")
            norm, symbol_len, tl, consumed = read_ncount(body)
            parsed.append((count, norm, symbol_len, tl, body[consumed:]))
        ops, steps, tlm, asweep = td.build_tans_batch(parsed, n_states, coder=coder)
        kw = dict(steps=steps, n_states=n_states, table_log=tlm)
        got = _sharded("decode_tans_sharded", "tans", mesh,
                       lambda: M.decode_tans_sharded(mesh, *ops, **kw, asweep=asweep))
        _same(f"decode_tans_sharded ({coder})", got,
              td.tans_decode(*rd.to_device(ops, mesh[0]), **kw))
        for s, d in enumerate(datas):
            if not np.array_equal(got[s].numpy().view(np.uint16).reshape(-1)[: d.size], d):
                raise AssertionError(f"decode_tans_sharded ({coder}): mismatch in stream {s}")


def _encode_operands(rng, n: int, n_sym: int, alias: bool):
    """``mic_tpu``'s sharded-encode operands: ``n`` streams of ``n_sym``
    symbols, each with its own table (tableLog <= 11), ranks u16 [n, steps,
    128]; with ``alias`` also the run tables (u32 [n, 2, 128] each)."""
    specs, ranks, tls, runs = [], [], [], []
    for _s in range(n):
        syms = (rng.standard_normal(n_sym) * 9 + 60).clip(0, 255).astype(np.uint16)
        counts, _mc, sl = histogram(syms)
        tl = min(optimal_table_log(11, n_sym, sl), 11)
        norm = normalize_count(counts, n_sym, tl, sl)
        _sy, _fs, _bs, freq, cumul = device_tables(norm, tl)
        present = np.nonzero(freq)[0]
        lut = np.zeros(65536, np.uint16)
        lut[present] = np.arange(len(present), dtype=np.uint16)
        specs.append((freq[present].astype(np.uint32), cumul[present].astype(np.uint32)))
        ranks.append(lut[syms])
        tls.append(tl)
        if alias:
            runs.append(alias_construct(norm, tl)["enc_runs"])
    steps = (-(-n_sym // 128) + 7) // 8 * 8
    te1, te2, asweep = renc.build_enc_tables(specs, 11)
    rk = np.zeros((n, steps * 128), np.uint16)
    for i, r in enumerate(ranks):
        rk[i, :n_sym] = r
    cnt = np.full((n, 128), n_sym, np.uint32)
    tls = np.repeat(np.array(tls, np.uint32)[:, None], 128, axis=1)
    ops = [rk.reshape(n, steps, 128), te1, te2, cnt, tls]
    if alias:
        ar1 = np.full((n, 256), 0xFFFFFFFF, np.uint32)
        ar2 = np.zeros((n, 256), np.uint32)
        for i, (starts, bases) in enumerate(runs):
            ar1[i, : len(starts)] = starts
            ar2[i, : len(bases)] = bases
        ops[3:3] = [ar1.reshape(n, 2, 128), ar2.reshape(n, 2, 128)]
    return tuple(ops), steps, asweep


def _encode(mesh, n: int) -> None:
    """Both device encodes sharded, equal to the unsharded call bit for bit."""
    rng = np.random.default_rng(17)
    for alias, name, counter, sharded, kernel in (
            (False, "encode_strips_sharded", "encode", M.encode_strips_sharded,
             renc.rans_encode),
            (True, "encode_alias_sharded", "encode_alias", M.encode_alias_sharded,
             renc.rans_encode_alias)):
        ops, steps, asweep = _encode_operands(rng, n, 1024, alias)
        got = _sharded(name, counter, mesh, lambda: sharded(mesh, *ops, steps=steps,
                                                            asweep=asweep))
        dev_ops = [torch.from_numpy(a.view(np.int16 if a.dtype == np.uint16 else np.int32))
                   .to(mesh[0]) for a in ops]
        _same(name, got, kernel(*dev_ops, steps=steps))


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Every path of ``__graft_entry__.dryrun_multichip`` over a mesh of
    ``n_devices`` devices: the strip-sharded scan-tier decode, the fused
    zzd decode, the device r-mode and auto-r + best encodes (byte-identical
    to the host) and the r-mode decode of the device's bytes, the FF 41
    decode at tableLogs 9-11 mixed, the 4-state tANS and FF 08 8-state rANS
    decodes, and both sharded encodes (the FF 41 one as
    ``tests/test_mesh.py::test_sharded_alias_encode`` runs it).

    ``devices`` None takes the first ``n_devices`` visible CUDA devices,
    repeated round-robin where fewer are visible (one card runs every
    shard), and prints them; with no visible CUDA device ``devices`` must
    be given.  Raises on any mismatch."""
    n = int(n_devices)
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible == 0:
            raise RuntimeError("dryrun_multichip: no CUDA device is visible; pass the devices")
        devices = [torch.device("cuda", i % visible) for i in range(n)]
        print(f"dryrun_multichip: {n} shards on {[str(d) for d in devices]} "
              f"({visible} visible CUDA device(s))")
    mesh = M.make_strip_mesh(devices)
    if len(mesh) != n:
        raise ValueError(f"dryrun_multichip: {len(mesh)} devices for {n} shards")
    for path in (_scan, _zzd, _rmode, _alias, _tans, _encode):
        path(mesh, n)
    cuda = sum(d.type == "cuda" for d in mesh)
    print(f"dryrun_multichip OK: {n}-device mesh, strip-sharded decode exact (scan tier + "
          f"zzd + fused-rle + alias + reference-tans + reference-rans paths) + sharded "
          f"encode exact (both families) + device r-mode / auto-r+best encode "
          f"byte-identical; {cuda} kernel launch(es) a sharded call ({cuda} CUDA shards)")
