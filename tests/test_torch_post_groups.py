"""The post path's symbols-out strips as groups of the direct kernel's
launch: the packed front end with no inverse (``rans_decode_packed``), the
two-table front end (``rans_decode``) and the FF 41 front end with
``fused=False``, beside the direct modes, in one ``DirectPacking``.

* the two-table operands the kernel stages (tfb as it is, tsym narrowed
  to u16) against ``mic_tpu``'s ``build_pallas_tables``, slot for slot;
* ``rans_decode_direct_groups_plain`` over mixed groups against each
  group's plain twin and ``mic_tpu``'s Pallas kernels in interpret mode
  (``rans_decode_pallas_packed``, ``rans_decode_pallas`` at tl 13,
  ``rans_decode_pallas_alias``) and the strips' symbols or pixels; the tl
  15 strip against the host decoder ``mict_decode_numpy`` instead of
  Pallas (interpret mode sweeps 256 table tiles a step there: ~45 s for 8
  steps), the zzd and pdd groups beside them against their pixels
  (``test_torch_direct_decode.py`` holds those two to Pallas);
* ``DirectPacking``'s layout: a direct-only plan packs as before, one
  launch takes every group, its largest strip sets the strips a block
  (a wide pdd strip's column carry, a tl 15 two-table strip's tables),
  and tl 16 reads its tables from device memory;
* a pdd strip too wide for its column carry (110,208 x 8, written by
  ``mic_tpu``) runs unfused, decoded against ``micw_decompress_host``;
  98,176 x 8 keeps the carry.

Tolerance 0 on whole arrays: a lossless codec.  The ``cuda`` tests hold
the merged launch against its plain twin on the card for every group
kind (tl 16 from device memory, the tables staged and not), the wide pdd
strips encoded on the card, and the corrupted streams of
``test_torch_corruption.py`` through it; they need no jax: ``python -m
pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_post_groups.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mic_tpu_torch import MicwDecodePlan, micw_compress_device
from mic_tpu_torch.tpu import rans_decode as rd
from mic_tpu_torch.tpu import strips as st
from mic_tpu_torch.tpu.device_rans import mict_parse

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "web" / "testdata"
PORT_DATA = ROOT / "tests" / "data" / "torch_port"
CPU = torch.device("cpu")
TL13, TL15 = PORT_DATA / "CT_dev_tl13.micw", PORT_DATA / "CT_dev_1strip_tl15.micw"


@pytest.fixture(scope="module")
def ref():
    """mic_tpu's encoders, table builds, Pallas kernels and plan programs
    (needs jax)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from mic_tpu.tpu import device_rans, pallas_rans, strips

    return jnp, device_rans, pallas_rans, strips


def _strips_of(path, n):
    """The first ``n`` parsed MICT streams of a container, and their blobs."""
    blobs = [s[0] for s in st.micw_parse(path.read_bytes())[7][:n]]
    return [mict_parse(b) for b in blobs], blobs


def _one_symbol_tl16(sym=300, seed=0):
    """A parsed FF 57 stream of one symbol at tl 16: its freq is 2^16,
    which wraps to 0 in tfb's u32, as in mic_tpu."""
    rng = np.random.default_rng(seed)
    norm = np.zeros(sym + 1, np.int64)
    norm[sym] = 1 << 16
    states = rng.integers(1 << 16, 1 << 31, 128).astype(np.uint32)
    words = rng.integers(0, 1 << 16, 300).astype(np.uint16)
    return (128, 16, 8 * 128, states, words, norm, sym + 1, None)


# ---------------------------------------------------------------------------
# The two-table operands
# ---------------------------------------------------------------------------

TABLE_CASES = ["tl7", "tl13", "tl15", "tl16", "alphabet_over_4096", "one_symbol_tl16"]


@pytest.mark.parametrize("case", TABLE_CASES)
def test_two_table_operands_match_pallas_tables(ref, case):
    """The kernel's two-table operands: tfb exactly as mic_tpu's
    ``build_pallas_tables`` builds it, tsym narrowed to u16 without loss,
    slot for slot, padded to a multiple of 8 with 0."""
    _jnp, dr, pr, _rst = ref
    rng = np.random.default_rng(TABLE_CASES.index(case))
    if case == "tl7":
        data = np.minimum(rng.geometric(0.1, 3000), 40).astype(np.uint16)
        parsed = [dr.mict_parse(dr.mict_encode(data, lanes=128, table_log=6))]
        tl = 7
    elif case == "tl13":
        parsed, tl = _strips_of(TL13, 2)[0], 13
    elif case in ("tl15", "tl16"):  # tl 16: the tl 15 strip's tables tiled up
        parsed, tl = _strips_of(TL15, 1)[0], int(case[2:])
    elif case == "alphabet_over_4096":
        data = (30000 + np.abs(rng.standard_normal(60000)) * 1500).astype(np.uint16)
        parsed = [dr.mict_parse(dr.mict_encode(data, lanes=128, table_log=13))]
        assert np.count_nonzero(parsed[0][5]) > 4096
        tl = 13
    else:
        parsed, tl = [_one_symbol_tl16()], 16
    assert max(p[1] for p in parsed) <= tl
    want = pr.build_pallas_tables(parsed, tl)
    built = rd.build_pallas_tables(parsed, tl)
    tsym, tfb = rd.to_device(built[1:3], CPU)
    got_sym = rd.two_table_symbols(tsym)
    S, ts = want[1].shape
    assert ts == 1 << tl and got_sym.shape == (S, (ts + 7) // 8 * 8)
    assert got_sym.dtype == torch.int16
    assert np.array_equal(tfb.numpy().view(np.uint32), want[2])
    sym16 = got_sym.numpy().view(np.uint16)
    assert np.array_equal(sym16[:, :ts].astype(np.uint32), want[1])
    assert not sym16[:, ts:].any()
    if case == "one_symbol_tl16":
        assert (want[1] == 300).all() and not (want[2] >> 16).any()  # freq 2^16 wrapped


def test_one_symbol_tl16_decodes_its_symbol():
    """The wrapped freq sends the states off their stream (in mic_tpu too),
    but every slot holds the one symbol: the plain twin and the merged
    launch's plain twin give it at every step."""
    built = rd.build_pallas_tables([_one_symbol_tl16()], 16)
    ops = rd.to_device(built[:6], CPU)
    out = rd.rans_decode(*ops, steps=8)
    assert (out == 300).all()
    (grp,) = rd.rans_decode_direct_groups([(rd.rans_decode, ops, {"steps": 8})])
    assert torch.equal(grp, out)


# ---------------------------------------------------------------------------
# Mixed groups through the merged launch's plain twin
# ---------------------------------------------------------------------------


def _smooth(rng, h, w, axis=1):
    img = rng.standard_normal((h, w)).cumsum(axis=axis) * 9 + 600
    return img.clip(0, 4095).astype(np.uint16)


def _ws(S, w):
    return np.full((S, 128), w // 128, np.uint32)


@pytest.fixture(scope="module")
def mixed(ref):
    """Groups of every kind, on the CPU: per group (name, (fn, operands,
    kwargs), numpy operands, what each strip encodes (symbols or pixels),
    the Pallas call's extra arguments or None)."""
    _jnp, dr, pr, rst = ref
    rng = np.random.default_rng(101)
    out = []
    # packed tables, no inverse: three symbol streams (tl 8), 12-16 steps
    datas = [np.minimum(rng.geometric(4.0 / cap, n), cap).astype(np.uint16)
             for n, cap in ((1500, 60), (1900, 150), (2000, 250))]
    parsed = [dr.mict_parse(dr.mict_encode(d, lanes=128, table_log=tl))
              for d, tl in zip(datas, (9, 10, 11))]
    tl = max(max(p[1] for p in parsed), 7)
    b = pr.build_packed_tables(parsed, tl)
    out.append(("packed", (rd.rans_decode_packed, b[:6], {"steps": b[7]}), datas,
                dict(table_log=tl, asweep=b[8])))
    # two tables at tl 13 (two CT strips), 8 steps of their 512
    parsed, blobs = _strips_of(TL13, 2)
    b = pr.build_pallas_tables(parsed, 13)
    out.append(("two_table_tl13", (rd.rans_decode, b[:6], {"steps": 8}),
                [dr.mict_decode_numpy(x) for x in blobs], dict(table_log=13)))
    # two tables at tl 15 beside a tl 9 stream tiled up to it
    parsed, blobs = _strips_of(TL15, 1)
    small = np.minimum(rng.geometric(0.02, 2000), 300).astype(np.uint16)
    parsed.append(dr.mict_parse(dr.mict_encode(small, lanes=128, table_log=9)))
    b = pr.build_pallas_tables(parsed, 15)
    out.append(("two_table_tl15", (rd.rans_decode, b[:6], {"steps": 16}),
                [dr.mict_decode_numpy(blobs[0]), small], None))
    # FF 41 symbols, with escapes and without
    for name, p_esc in (("alias_esc", 0.05), ("alias", 0.0)):
        syms = []
        for n in (2900, 3072):  # 23-24 steps: fewer keep every symbol
            base = np.minimum(rng.geometric(0.08, n), 299 if p_esc else 200).astype(np.uint16)
            syms.append(np.where(rng.random(n) < p_esc, rng.integers(0, 4000, n),
                                 base).astype(np.uint16))
        parsed = [dr.mict_parse(dr.mict_encode_alias(s, table_log=11)) for s in syms]
        esc = any(len(p[7][1]) for p in parsed)
        assert esc == (p_esc > 0), name
        b = pr.build_alias_bucket_tables(parsed)
        out.append((name, (rd.rans_decode_alias, b[:9] + (_ws(2, 128),),
                           {"steps": b[10], "vdd_ws": 0, "fused": False, "esc": esc}),
                    syms, dict(esc=esc)))
    # the direct modes beside them: zzd and pdd (the column sum fused)
    for pred, kw in (("zzd", {}), ("pdd", {"pdd_ws": 2})):
        pxs = [_smooth(rng, 8, 256).ravel() for _ in range(2)]
        parsed = [dr.mict_parse(dr.mict_encode(getattr(rst, f"_{pred}_syms")(px, 256, 8),
                                               lanes=128, table_log=11)) for px in pxs]
        tl = max(max(p[1] for p in parsed), 7)
        b = pr.build_packed_tables(parsed, tl)
        out.append((pred, (rd.rans_decode_zzd, b[:6] + (_ws(2, 256),),
                           dict(kw, steps=b[7], vdd_ws=0)), pxs, None))
    return [(name, (fn, rd.to_device(ops, CPU), kw), ops, truth, extra)
            for name, (fn, ops, kw), truth, extra in out]


def _pallas(ref, name, group, ops, extra):
    jnp, _dr, pr, _rst = ref
    _fn, _t, kw = group
    S, steps = ops[0].shape[0], kw["steps"]
    jops = tuple(map(jnp.asarray, ops))
    if name == "packed":
        got = pr.rans_decode_pallas_packed(*jops, steps=steps, n_strips=S, **extra)
    elif name == "two_table_tl13":
        got = pr.rans_decode_pallas(*jops, steps=steps, n_strips=S, **extra)
    else:
        got = pr.rans_decode_pallas_alias(*jops, steps=steps, n_strips=S, vdd_ws=0,
                                          fused=False, **extra)
    return np.asarray(got).reshape(S, -1)


def test_groups_plain_matches_twins_and_pallas(ref, mixed):
    """One list of every group kind through the merged launch's plain twin:
    each output equals its wrapper's plain twin (pdd: with the column sum)
    on the whole array, mic_tpu's Pallas kernel for the symbols-out
    groups but tl 15, and what its strips encode (tl 15: the host
    decoder's symbols)."""
    groups = [g for _n, g, _o, _t, _e in mixed]
    outs = rd.rans_decode_direct_groups(groups)
    for (name, (fn, ops, kw), np_ops, truth, extra), got in zip(mixed, outs):
        S = ops[0].shape[0]
        assert got.shape == (S, kw["steps"], 128) and got.dtype == torch.int16, name
        own = {k: v for k, v in kw.items() if k != "pdd_ws"}
        want = rd._DIRECT_PLAIN[fn](*ops, **own)
        if kw.get("pdd_ws"):
            want = rd._pdd_columns_plain(want, kw["pdd_ws"])
        assert torch.equal(got, want), name
        flat = got.numpy().view(np.uint16).reshape(S, -1)
        if extra is not None:
            pallas = _pallas(ref, name, (fn, ops, kw), np_ops, extra)
            assert np.array_equal(flat[:, :pallas.shape[1]], pallas), name
        for i, t in enumerate(truth):
            n = min(t.size, flat.shape[1])
            assert np.array_equal(flat[i, :n], t[:n]), (name, i)


def test_mixed_groups_pack_as_designed(mixed):
    """The mixed groups in one packing: the symbols-out groups take
    inverse 0, the two-table groups front end 2 and their u16 symbols;
    one launch, whose largest strip (tl 15: 196 KB) leaves room for one
    strip a block."""
    groups = [g for _n, g, _o, _t, _e in mixed]
    pk = rd.DirectPacking(groups)
    names = [n for n, *_r in mixed]
    args = {n: d["arg"].tolist() for n, d in zip(names, pk.desc)}
    assert args["packed"][0] == 0 and args["packed"][6:] == [0, 0, 0, 0]
    assert args["alias_esc"][0] == 1 and args["alias_esc"][6:] == [0, 0, 1, 0]
    assert args["two_table_tl13"][:3] == [2, 8192, 8192] and args["two_table_tl13"][6:] == [0] * 4
    assert args["zzd"][6:8] == [1, 0] and args["pdd"][6:8] == [3, 2]
    ptr = {n: d["ptr"].tolist() for n, d in zip(names, pk.desc)}
    for n in ("two_table_tl13", "two_table_tl15"):
        _fn, ops, _kw = groups[names.index(n)]
        assert ptr[n][1] == ops[2].data_ptr() and ptr[n][2] not in (0, ops[1].data_ptr())
        assert ptr[n][9] == 0  # no ws: the symbols need none
    i15 = names.index("two_table_tl15")
    assert pk.strip_words[i15] == 1024 + 32768 + 16384 == max(pk.strip_words)
    assert (pk.blocks[:, 1:, 0] == -1).all() and (pk.blocks[:, 0, 2] == 0).all()
    assert pk.smem_bytes == 4 * pk.strip_words[i15]
    assert sorted(map(tuple, pk.blocks[:, 0, :2].tolist())) == [
        (g, s) for g, (_f, ops, _k) in enumerate(groups) for s in range(ops[0].shape[0])]
    assert pk.families == ["rans_decode", "rans_decode_alias", "rans_decode_packed",
                           "rans_decode_zzd"]


# ---------------------------------------------------------------------------
# DirectPacking's layout (no jax)
# ---------------------------------------------------------------------------


def _old_layout(groups, per=4, sw=None):
    """The direct-only rule: per consecutive strips a block, longest chain
    first, one budget for the launch (its largest block); ``sw``, the
    strips' shared-memory words, where they are not the staged ones."""
    staged, chain = [], []
    for fn, ops, kw in groups:
        S, _t, args, words = rd._direct_group(fn, ops, kw)
        staged.append(words)
        chain.append((args[5], S))
    sw = staged if sw is None else sw
    steps, n = np.array(chain, np.int64).T
    grp = np.repeat(np.arange(len(chain)), n)
    strip = np.arange(grp.size) - np.repeat(np.cumsum(n) - n, n)
    order = np.lexsort((strip, grp, -steps[grp]))
    grp, strip = grp[order], strip[order]
    team = np.arange(grp.size) // per * 4 + np.arange(grp.size) % per
    need = np.asarray(sw, np.int64)[grp]
    at = np.cumsum(need) - need
    blocks = np.full((-(-grp.size // per) * 4, 4), -1, np.int32)
    blocks[team, 0], blocks[team, 1] = grp, strip
    blocks[team, 2], blocks[team, 3] = at - at[np.arange(grp.size) // per * per], 0
    smem = 4 * int(np.add.reduceat(need, np.arange(0, grp.size, per)).max())
    return blocks.reshape(-1, 4, 4), smem


DIRECT_BATCH = [(TESTDATA / "CT_dev.micw", 256), (TESTDATA / "MR_dev.micw", 32),
                (TESTDATA / "MR_dev_alias.micw", 32), (TESTDATA / "wide_banded.micw", 32),
                (PORT_DATA / "CT_dev_alias.micw", 32)]


def test_direct_only_plan_packs_as_before():
    """chip_smoke.py's decode batch (1408 direct strips, 9 buckets, both
    front ends): the direct-only rule's blocks and shared memory, 352
    blocks of 69,760 bytes, one launch; and at 1-3 strips a block as well."""
    plan = MicwDecodePlan([p.read_bytes() for p, n in DIRECT_BATCH for _ in range(n)], CPU)
    groups = plan._direct_groups
    for per in (4, 3, 2, 1):
        pk = rd.DirectPacking(groups, per_block=per)
        blocks, smem = _old_layout(groups, per)
        assert np.array_equal(pk.blocks, blocks) and pk.smem_bytes == smem, per
    pk = rd.DirectPacking(groups)
    assert (len(pk.blocks), pk.smem_bytes) == (352, 69760)


def _two_table_group(S, tl, steps=16, rows=40):
    """A two-table group of zero operands at table width 2^tl (the layout
    does not read them)."""
    z = torch.zeros
    ops = (z((S, 128), dtype=torch.int32), z((S, 1 << tl), dtype=torch.int32),
           z((S, 1 << tl), dtype=torch.int32), z((S, rows, 128), dtype=torch.int32),
           z((S, 128), dtype=torch.int32), z((S, 128), dtype=torch.int32))
    return (rd.rans_decode, ops, {"steps": steps})


def _strips_a_block(pk) -> set:
    return {int((blk[:, 0] >= 0).sum()) for blk in pk.blocks[:-1]}


def test_two_table_strips_set_the_strips_a_block():
    """Beside a direct plan: tl 12 and 13 (28,672 and 53,248 bytes a
    strip) keep four strips a block, tl 15 (200,704 bytes) leaves room
    for one in every block of the launch, tl 16 reads its tables from
    device memory (a strip takes its ring only); every layout is the
    direct-only rule's.  ``_tables_from_memory`` reads every two-table
    group's tables from device memory: the direct plan's blocks again."""
    plan = MicwDecodePlan([p.read_bytes() for p, n in DIRECT_BATCH for _ in range(n)], CPU)
    base = rd.DirectPacking(plan._direct_groups)
    extra = [_two_table_group(3, 13), _two_table_group(4, 12), _two_table_group(2, 15),
             _two_table_group(5, 16)]
    g13, g12, g15, g16 = range(len(plan._direct_groups), len(plan._direct_groups) + 4)
    groups = plan._direct_groups + extra
    pk = rd.DirectPacking(groups)
    assert [pk.strip_words[g] for g in (g13, g12, g15, g16)] == [
        1024 + 8192 + 4096, 1024 + 4096 + 2048, 1024 + 32768 + 16384, 1024]
    assert [int(pk.desc["arg"][g][9]) for g in (g13, g12, g15, g16)] == [0, 0, 0, 1]
    assert _strips_a_block(pk) == {1} and pk.smem_bytes == 4 * (1024 + 32768 + 16384)
    assert np.array_equal(pk.blocks, _old_layout(groups, 1, pk.strip_words)[0])
    without15 = plan._direct_groups + extra[:2] + extra[3:]
    pk = rd.DirectPacking(without15)
    assert _strips_a_block(pk) == {4} and pk.smem_bytes <= 4 * rd._MAX_BLOCK_WORDS
    blocks, smem = _old_layout(without15, 4, pk.strip_words)
    assert np.array_equal(pk.blocks, blocks) and pk.smem_bytes == smem
    dev = rd._tables_from_memory(rd.DirectPacking(groups))
    assert [int(dev.desc["arg"][g][9]) for g in (g13, g12, g15, g16)] == [1, 1, 1, 1]
    assert [dev.strip_words[g] for g in (g13, g12, g15, g16)] == [1024] * 4
    assert _strips_a_block(dev) == {4} and dev.smem_bytes == base.smem_bytes


def _pdd_group(S, width, steps=16, rows=40):
    """A fused pdd group of zero operands, tl 12 tables with a 4096
    alphabet, ``width`` pixels a row (``width / 128`` chunks: the column
    carry takes 64 words a chunk)."""
    z = torch.zeros
    ops = (z((S, 128), dtype=torch.int32), z((S, 4096), dtype=torch.int32),
           z((S, 4096), dtype=torch.int32), z((S, rows, 128), dtype=torch.int32),
           z((S, 128), dtype=torch.int32), z((S, 128), dtype=torch.int32),
           z((S, 128), dtype=torch.int32))
    return (rd.rans_decode_zzd, ops, {"steps": steps, "pdd_ws": width // 128})


@pytest.mark.parametrize("width,per", [(16384, 3), (32768, 2), (65536, 1)])
def test_wide_pdd_strips_fit_a_block(width, per):
    """A wide pdd group beside a direct plan: its strips (ring, tables and
    a column carry of ``width / 2`` words) leave room for ``per`` strips a
    block, every block within the card's shared memory, as the
    direct-only rule lays them out."""
    plan = MicwDecodePlan([p.read_bytes() for p, n in DIRECT_BATCH for _ in range(n)], CPU)
    groups = plan._direct_groups + [_pdd_group(5, width)]
    pk = rd.DirectPacking(groups)
    assert pk.strip_words[-1] == 1024 + 4100 + 4100 + width // 2
    assert _strips_a_block(pk) == {per} and pk.smem_bytes <= 4 * rd._MAX_BLOCK_WORDS
    blocks, smem = _old_layout(groups, per)
    assert np.array_equal(pk.blocks, blocks) and pk.smem_bytes == smem


# width -> whether a pdd strip of that width, 8 rows, keeps its column carry
# in the kernel (98,176: 767 chunks, 49,088 words of carry beside ring and
# tables; 110,208: 55,104 words, past a block's 57,984); both unbanded
WIDE_PDD = {98176: True, 110208: False}


def _wide_pdd_image(width, height=8, seed=11):
    """A smooth ``width`` x ``height`` image with noise (a numpy seed)
    whose pdd strip compresses."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:height, :width]
    px = 2000 + 900 * np.sin(x / 700.0) + 40 * y + rng.integers(0, 24, (height, width))
    return px.astype(np.uint16).ravel()


@pytest.mark.parametrize("width", sorted(WIDE_PDD))
def test_wide_pdd_strip_without_room_runs_unfused(ref, width):
    """A pdd container written by ``mic_tpu`` whose one strip is a row of
    ``width`` pixels: where ring, tables and column carry pass a block's
    shared memory the plan gives the bucket ``pdd_ws`` 0 (the kernel's
    row prefix, the column sum in ``finish``), else the kernel's column
    sum; the packing fits a block either way, on the CPU as on the card,
    and the unfused plan decodes bit-exact to ``micw_decompress_host``."""
    strips = ref[3]
    px = _wide_pdd_image(width)
    blob = strips.micw_compress(px, width, 8, int(px.max()), predictor="pdd")
    plan = MicwDecodePlan([blob], CPU)
    ((key, b),) = plan.buckets.items()
    fused = WIDE_PDD[width]
    assert key[0] == "pdd" and b.pdd_ws == (width // 128 if fused else 0)
    fn, ops, kw = b.launch
    assert rd.direct_strip_fits(fn, ops, dict(kw, pdd_ws=width // 128)) == fused
    assert rd.DirectPacking(plan._direct_groups).smem_bytes <= 4 * rd._MAX_BLOCK_WORDS
    if not fused:
        out = plan.assemble(plan.run())[0][0]
        assert np.array_equal(out, strips.micw_decompress_host(blob)[0])
        assert np.array_equal(out, px)


def test_plan_puts_post_buckets_in_the_direct_launch():
    """A plan of post-path containers (avg: packed symbols; CT at tl 13
    and 15: two tables; an MR_dev_alias copy whose buckets are direct) on
    the CPU: every post bucket is a group of the direct kernel's launch,
    with its wrapper's own arguments, and the run equals each bucket's
    own call."""
    blobs = [(TESTDATA / "MR_dev_auto.micw").read_bytes(), TL13.read_bytes(),
             TL15.read_bytes(), (TESTDATA / "MR_dev_alias.micw").read_bytes()]
    plan = MicwDecodePlan(blobs, CPU)
    assert plan._direct_keys == list(plan.buckets)
    fns = {k: g[0] for k, g in zip(plan._direct_keys, plan._direct_groups)}
    forms = {k[1]: fns[k] for k in plan.buckets if k[0] == "post"}
    assert forms == {"packed": rd.rans_decode_packed, "two_table": rd.rans_decode}
    for k, (fn, ops, kw) in zip(plan._direct_keys, plan._direct_groups):
        assert ops is plan.buckets[k].ops and fn is plan.buckets[k].fn, k
        assert ("pdd_ws" in kw) == (k[0].lstrip("a") == "pdd"), k
    pk = rd.DirectPacking(plan._direct_groups)
    assert _strips_a_block(pk) == {1}  # tl 15: 196 KB a strip
    plan = MicwDecodePlan([blobs[0], blobs[1], blobs[3]], CPU)  # decoded: without tl 15
    assert _strips_a_block(rd.DirectPacking(plan._direct_groups)) == {4}
    run = plan.run()
    for k, b in plan.buckets.items():
        assert torch.equal(run[k], b()), k


# ---------------------------------------------------------------------------
# On the card (skipped elsewhere)
# ---------------------------------------------------------------------------


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_groups(dev):
    """Groups of every kind from the fixtures, on ``dev``: a post plan's
    (packed symbols, two tables at tl 13 and 15), a direct plan's (FF 57
    and FF 41, pdd fused), FF 41 symbols with and without escapes, the tl
    15 strip's tables tiled to 2^16 (read from device memory) and the
    one-symbol tl 16 strip."""
    post = MicwDecodePlan([(TESTDATA / "MR_dev_auto.micw").read_bytes(), TL13.read_bytes(),
                           TL15.read_bytes()] * 2, dev)
    direct = MicwDecodePlan([(TESTDATA / n).read_bytes() for n in
                             ("MR_dev.micw", "MR_dev_alias.micw", "wide_banded.micw")]
                            + [(PORT_DATA / "CT_dev_alias.micw").read_bytes()], dev)
    groups = post._direct_groups + direct._direct_groups
    for fn, ops, kw in direct._direct_groups:
        if fn is rd.rans_decode_alias:
            own = {k: v for k, v in kw.items() if k != "pdd_ws"}
            groups += [(fn, ops, dict(own, vdd_ws=0, fused=False, esc=e)) for e in (True, False)]
            break
    parsed, _b = _strips_of(TL15, 1)
    for p, steps in ((parsed[0], 64), (_one_symbol_tl16(), 8)):
        built = rd.build_pallas_tables([p, p], 16)
        groups.append((rd.rans_decode, rd.to_device(built[:6], dev), {"steps": steps}))
    return groups


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [True, False])
@pytest.mark.parametrize("per_block", [4, 1])
def test_cuda_merged_launch_matches_plain(stage, per_block):
    """Every group kind in one launch, kernel == plain twin on whole
    arrays, with the tables staged and read from device memory, four
    strips a block (one where tl 15 is staged) and one."""
    dev = _need_cuda()
    groups = _card_groups(dev)
    want = rd.rans_decode_direct_groups_plain(groups)
    pk = rd.DirectPacking(groups, per_block=per_block)
    if not stage:
        rd._tables_from_memory(pk)
    got = rd._direct_launch(pk)
    torch.cuda.synchronize()
    for g, w, (fn, _o, kw) in zip(got, want, groups):
        assert torch.equal(g, w), (fn.__name__, kw)


@pytest.mark.cuda
def test_cuda_wrappers_and_plan_count_their_launches():
    """The symbols-out wrappers launch the direct kernel once a call and
    equal their plain twins; a plan's run is one launch of it, with a tl
    15 strip too, and decodes its pixels."""
    dev = _need_cuda()
    ct = np.fromfile(TESTDATA / "CT_dev.raw", dtype="<u2")
    mr = np.fromfile(TESTDATA / "MR_dev_auto.raw", dtype="<u2")
    for blobs, pxs, launches in (([(TESTDATA / "MR_dev_auto.micw").read_bytes(),
                                   TL13.read_bytes()], [mr, ct], 1),
                                 ([TL13.read_bytes(), TL15.read_bytes()], [ct, ct], 1)):
        plan = MicwDecodePlan(blobs, dev)
        before = rd.rans_decode_direct_groups.launches
        run = plan.run()
        torch.cuda.synchronize()
        assert rd.rans_decode_direct_groups.launches == before + launches
        assert plan.verify_batch(run, pxs) == 0
        for b in plan.buckets.values():
            n = b.fn.launches
            got = b.fn(*b.ops, **b.kwargs)
            torch.cuda.synchronize()
            assert b.fn.launches == n + 1
            assert torch.equal(got, rd._DIRECT_PLAIN[b.fn](*b.ops, **b.kwargs))


@pytest.mark.cuda
@pytest.mark.parametrize("width", sorted(WIDE_PDD))
def test_cuda_wide_pdd_strip_decodes(width):
    """The wide pdd strips encoded on the card by the port: the plan keeps
    the CPU's choice of ``pdd_ws`` and decodes every pixel in one launch."""
    dev = _need_cuda()
    px = _wide_pdd_image(width)
    blob = micw_compress_device(px, width, 8, int(px.max()), dev, predictor="pdd")
    plan = MicwDecodePlan([blob], dev)
    assert [b.pdd_ws for b in plan.buckets.values()] == [width // 128 * WIDE_PDD[width]]
    before = rd.rans_decode_direct_groups.launches
    run = plan.run()
    torch.cuda.synchronize()
    assert rd.rans_decode_direct_groups.launches == before + 1
    assert plan.verify_batch(run, [px]) == 0


@pytest.mark.cuda
def test_cuda_corrupt_post_streams_through_the_merged_launch():
    """The corrupted streams of test_torch_corruption.py on the post path
    (avg through the packed front end, CT at tl 13 through two tables)
    through the merged launch, tables staged and from device memory: in
    bounds, and equal to the plain twin."""
    from test_torch_corruption import CASES, _corrupt

    dev = _need_cuda()
    checked = 0
    for name, kind in CASES:
        if name not in ("MR_dev_auto.micw", "CT_dev_tl13.micw"):
            continue
        try:
            plan = MicwDecodePlan([_corrupt(name, kind)], dev)
        except (ValueError, NotImplementedError):
            continue
        want = rd.rans_decode_direct_groups_plain(plan._direct_groups)
        for stage in (True, False):
            pk = rd.DirectPacking(plan._direct_groups)
            if not stage:
                rd._tables_from_memory(pk)
            got = rd.rans_decode_direct_groups(plan._direct_groups, pk)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, kind, stage)
        checked += 1
    assert checked
