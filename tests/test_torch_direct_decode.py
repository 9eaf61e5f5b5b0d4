"""The port's merged direct-mode decode (every direct bucket of a plan in
one launch, pdd's column sum fused) against its one-bucket wrappers and
mic_tpu's Pallas kernels.

Both sides get the same numpy ``uint32`` operands, built by mic_tpu's own
encoders and builders from numpy-seeded images: ``rans_decode_pallas_zzd``
/ ``rans_decode_pallas_alias`` run in interpret mode on the CPU (pdd
through ``_stacked_zzd_fused`` / ``_stacked_alias_fused``, whose column
cumsum runs in the same program), the port's
``rans_decode_direct_groups`` runs its plain PyTorch twin (CPU tensors).
Tolerance 0 on the WHOLE output array, padding steps included: this is a
lossless integer codec.  The layout of ``DirectPacking``, the wrappers'
kept packings, the plan's use of the merged launch and a torch mirror of
the kernel's ballot ranks are checked without jax.

The ``cuda`` tests hold the kernel against its plain twin on the card, in
each form the design script builds; they need no jax:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_direct_decode.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from mic_tpu_torch import MicwDecodePlan
from mic_tpu_torch.tpu import rans_decode as rd
from mic_tpu_torch.tpu import strips as st

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "web" / "testdata"
CPU = torch.device("cpu")
FIXTURES = [TESTDATA / "MR_dev.micw", TESTDATA / "MR_dev_alias.micw",
            TESTDATA / "wide_banded.micw", ROOT / "tests" / "data" / "torch_port" /
            "CT_dev_alias.micw"]


@pytest.fixture(scope="module")
def ref():
    """mic_tpu's encoders, builders, Pallas kernels and plan programs
    (needs jax)."""
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


# (name, predictor, alias, (width, rows) of each strip, the group's keyword
# arguments): zzd at two widths, vdd at vdd_ws 1, 2, 4, pdd at ws 2, 3 (the
# shared-memory column carry) and 4, FF 41 pdd with escapes and vdd without,
# and FF 41 symbols (fused=False).
MIXED = [
    ("zzd", "zzd", False, ((128, 8), (256, 8)), {}),
    ("vdd1", "vdd", False, ((128, 8),) * 2, {"vdd_ws": 1}),
    ("vdd2", "vdd", False, ((256, 4),) * 2, {"vdd_ws": 2}),
    ("vdd4", "vdd", False, ((512, 2),) * 2, {"vdd_ws": 4}),
    ("pdd2", "pdd", False, ((256, 4),) * 2, {"pdd_ws": 2}),
    ("pdd3", "pdd", False, ((384, 4),) * 2, {"pdd_ws": 3}),
    ("pdd4", "pdd", False, ((512, 2),) * 2, {"pdd_ws": 4}),
    ("apdd_esc", "pdd", True, ((256, 12),) * 2, {"pdd_ws": 2}),
    ("avdd", "vdd", True, ((256, 8),) * 2, {"vdd_ws": 2}),
    ("araw", None, True, ((128, 24),) * 2, {"fused": False}),
]


@pytest.fixture(scope="module")
def mixed(ref):
    """The mixed group list: per group (name, (fn, operands, kwargs) on the
    CPU, the numpy operands, the pixels or symbols each strip encodes,
    the strips' (width, rows))."""
    _jnp, dr, pr, rst = ref
    rng = np.random.default_rng(90)
    out = []
    for name, pred, alias, geom, kw in MIXED:
        parsed, truth = [], []
        for w, h in geom:
            if pred is None:  # raw symbols, some escaped
                base = np.minimum(rng.geometric(0.08, w * h), 299).astype(np.uint16)
                syms = np.where(rng.random(w * h) < 0.05, rng.integers(0, 4000, w * h),
                                base).astype(np.uint16)
                truth.append(syms)
            else:
                axis = 0 if pred == "vdd" else 1
                px = (_spiky if "esc" in name else _smooth)(rng, h, w, axis).ravel()
                syms = getattr(rst, f"_{pred}_syms")(px, w, h)
                truth.append(px)
            blob = (dr.mict_encode_alias(syms, table_log=11) if alias
                    else dr.mict_encode(syms, lanes=128, table_log=11))
            parsed.append(dr.mict_parse(blob))
        if alias:
            built = pr.build_alias_bucket_tables(parsed)
            ops, steps = built[:9] + (_ws([w for w, _h in geom]),), built[10]
            esc = any(len(p[7][1]) for p in parsed)
            assert esc == (name in ("apdd_esc", "araw")), name
            fn, kw = rd.rans_decode_alias, dict(kw, esc=esc)
        else:
            tl = max(max(p[1] for p in parsed), 7)
            built = pr.build_packed_tables(parsed, tl)
            ops, steps = built[:6] + (_ws([w for w, _h in geom]),), built[7]
            fn = rd.rans_decode_zzd
        group = (fn, rd.to_device(ops, CPU), dict(kw, steps=steps))
        out.append((name, group, ops, truth, geom))
    return out


def _pallas(ref, group, ops, geom):
    """mic_tpu's output for one group: the Pallas kernel in interpret mode,
    and for pdd the plan program that runs its column cumsum after it."""
    jnp, _dr, pr, rst = ref
    fn, _t, kw = group
    S, steps, vdd_ws = len(geom), kw["steps"], kw.get("vdd_ws", 0)
    ops = tuple(map(jnp.asarray, ops))
    if kw.get("pdd_ws"):
        (w, h), = set(geom)
        stacked = tuple(a[None] for a in ops)
        if fn is rd.rans_decode_zzd:
            tl = int(np.log2(ops[1].shape[1]))
            got = rst._stacked_zzd_fused(stacked, steps=steps, chunk_s=S, tl=tl,
                                         asweep=ops[2].shape[1] // 128, pdd_geom=(w, h))
        else:
            got = rst._stacked_alias_fused(stacked, steps=steps, chunk_s=S, pdd_geom=(w, h),
                                           esc=kw["esc"])
        return np.asarray(got[0])
    if fn is rd.rans_decode_zzd:
        tl = int(np.log2(ops[1].shape[1]))
        return np.asarray(pr.rans_decode_pallas_zzd(
            *ops, steps=steps, n_strips=S, table_log=tl, asweep=ops[2].shape[1] // 128,
            vdd_ws=vdd_ws))
    return np.asarray(pr.rans_decode_pallas_alias(
        *ops, steps=steps, n_strips=S, vdd_ws=vdd_ws, fused=kw.get("fused", True),
        esc=kw["esc"]))


def test_groups_plain_matches_wrappers_and_pallas(ref, mixed):
    """One mixed group list through the merged launch's plain twin: each
    output equals its wrapper's plain twin (pdd: with the column sum),
    mic_tpu's Pallas kernel or plan program on whole arrays, and the
    pixels or symbols its strips encode."""
    groups = [g for _n, g, _o, _t, _g in mixed]
    outs = rd.rans_decode_direct_groups(groups)
    assert len(outs) == len(groups)
    for (name, (fn, ops, kw), np_ops, truth, geom), got in zip(mixed, outs):
        S, steps = len(geom), kw["steps"]
        assert got.shape == (S, steps, 128) and got.dtype == torch.int16, name
        own = {k: v for k, v in kw.items() if k != "pdd_ws"}
        want = rd._DIRECT_PLAIN[fn](*ops, **own)
        if kw.get("pdd_ws"):
            want = rd._pdd_columns_plain(want, kw["pdd_ws"])
        assert torch.equal(got, want), name
        flat = got.numpy().view(np.uint16).reshape(S, -1)
        pallas = _pallas(ref, (fn, ops, kw), np_ops, geom).reshape(S, -1)
        assert np.array_equal(flat[:, :pallas.shape[1]], pallas), name
        for i, t in enumerate(truth):
            assert np.array_equal(flat[i, :t.size], t), (name, i)


def test_pdd_columns_over_partial_rows():
    """pdd's column sum over a steps count that is not a multiple of the
    chunks a row (the shared-memory carry): equal to an int64 cumsum over
    the zero-padded image, then mod 2^16."""
    rng = np.random.default_rng(3)
    for S, steps, cw in ((2, 16, 3), (1, 8, 5), (3, 24, 12), (2, 8, 1)):
        out = torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, (S, steps, 128)).astype(np.int16))
        R = -(-steps // cw)
        img = np.zeros((S, R * cw * 128), np.int64)
        img[:, :steps * 128] = out.numpy().view(np.uint16).reshape(S, -1)
        want = (img.reshape(S, R, cw * 128).cumsum(1) & 0xFFFF).reshape(S, -1)[:, :steps * 128]
        got = rd._pdd_columns_plain(out, cw)
        assert np.array_equal(got.numpy().view(np.uint16).reshape(S, -1), want), (steps, cw)


@pytest.mark.parametrize("steps,w,sh", [(16, 256, 4), (8, 384, 4), (8, 512, 3),
                                        (8, 1536, 2), (8, 1024, 1)])
def test_finish_keeps_the_fused_columns(steps, w, sh):
    """A pdd bucket's finish on the column-summed output gives what the
    plan computed before (row prefix, zero pad to w * strip_h, int32
    cumsum, & 0xFFFF), also when the bucket's steps hold fewer pixels than
    a strip (a short last strip, columns past the output included)."""
    rng = np.random.default_rng(steps * w + sh)
    S = 3
    rows = torch.from_numpy(rng.integers(-2 ** 15, 2 ** 15, (S, steps, 128)).astype(np.int16))
    need = w * sh
    flat = rows.reshape(S, -1)
    if flat.shape[1] < need:
        flat = torch.nn.functional.pad(flat, (0, need - flat.shape[1]))
    img = (flat[:, :need].to(torch.int32) & 0xFFFF).reshape(S, sh, w)
    want = rd._as_i16(torch.cumsum(img, dim=1, dtype=torch.int32)).reshape(S, -1)
    fused = rd._pdd_columns_plain(rows, w // 128)
    got = st._fit_columns(fused.reshape(S, -1), w, need)
    assert torch.equal(got, want)


def _fixture_plan(device=CPU, paths=FIXTURES):
    return MicwDecodePlan([p.read_bytes() for p in paths], device)


def test_plan_runs_the_merged_launch_bit_exact():
    """A small phase-3-like plan (FF 57 and FF 41, zzd / vdd / pdd, banded
    pdd at 1024 steps) on the CPU: the direct buckets are the merged
    launch's groups, pdd's with ``pdd_ws``, every pixel equals the
    ``.raw``, each bucket's own call equals the run, and finish leaves a
    pdd bucket's columns as the launch summed them."""
    plan = _fixture_plan()
    keys = plan._direct_keys
    assert keys == [k for k, b in plan.buckets.items() if b.post is None]
    assert {g[0] for g in plan._direct_groups} == {rd.rans_decode_zzd, rd.rans_decode_alias}
    for k, (fn, ops, kw) in zip(keys, plan._direct_groups):
        pred = k[0].lstrip("a")
        assert kw.get("pdd_ws", 0) == (k[2] // 128 if pred == "pdd" else 0), k
        assert "pdd_ws" not in plan.buckets[k].kwargs  # the wrapper's own arguments
    run = plan.run()
    raws = [np.fromfile(TESTDATA / n, dtype="<u2")
            for n in ("MR_dev.raw", "MR_dev_alias.raw", "wide_banded.raw", "CT_dev.raw")]
    assert plan.verify_batch(run, raws) == 0
    for k, b in plan.buckets.items():
        assert torch.equal(run[k], b()), k
    (k, b), = [(k, b) for k, b in plan.buckets.items() if k[0] == "pdd" and k[1] == 1024]
    x = torch.arange(b.n * b.kwargs["steps"] * 128, dtype=torch.int32).to(torch.int16)
    assert torch.equal(b.finish(x), x.reshape(b.n, -1)[:, :k[2] * k[3]])


def test_direct_packing_layout():
    """Descriptors of the fixture plan's direct groups: outputs group
    after group, each strip's shared memory (ring, tables, the escapes'
    ring, vdd's and pdd's column carry), every strip once, 4 consecutive
    strips a block in longest-chain order at cumulative offsets, each
    group's arguments and operand pointers."""
    plan = _fixture_plan()
    groups = plan._direct_groups
    pk = rd.DirectPacking(groups)
    assert pk.families == ["rans_decode_alias", "rans_decode_zzd"]
    at = 0
    for (fn, ops, kw), off, shape, words, d in zip(groups, pk.out_offs, pk.out_shapes,
                                                   pk.strip_words, pk.desc):
        S = ops[0].shape[0]
        assert off == at and shape == (S, kw["steps"], 128) and d["off"] == at
        at += S * kw["steps"] * 128
        alias = fn is rd.rans_decode_alias
        esc = int(alias and kw["esc"])
        inv, cw = ((3, kw["pdd_ws"]) if kw.get("pdd_ws") else
                   (2, kw["vdd_ws"]) if kw["vdd_ws"] else (1, 0))
        assert d["arg"].tolist() == [
            int(alias), 0 if alias else ops[1].shape[1], 0 if alias else ops[2].shape[1],
            ops[4 if alias else 3].shape[1], ops[8].shape[1] if alias else 0, kw["steps"],
            inv, cw, esc, 0]
        ptrs = [t.data_ptr() for t in ops]
        if not alias:
            ptrs = ptrs[:3] + [0] + ptrs[3:6] + [0, 0] + ptrs[6:]
        assert d["ptr"].tolist() == ptrs
        tab = 384 + 2048 * esc if alias else sum((n + 4) // 4 * 4 for n in
                                                 (ops[1].shape[1], ops[2].shape[1]))
        assert words == 1024 + tab + 64 * cw * (inv >= 2)
    assert pk.out_total == at
    teams = pk.blocks.reshape(-1, 4)
    live = teams[teams[:, 0] >= 0]
    assert sorted(map(tuple, live[:, :2].tolist())) == [
        (g, s) for g, (_f, ops, _k) in enumerate(groups) for s in range(ops[0].shape[0])]
    steps = np.array([kw["steps"] for _f, _o, kw in groups])
    order = [(-steps[g], g, s) for g, s in live[:, :2].tolist()]
    assert order == sorted(order)  # longest chain first, then group and strip order
    assert (teams[:len(live), 0] >= 0).all()  # consecutive: only the last block has idle teams
    used = []
    for blk in pk.blocks:
        mine = blk[blk[:, 0] >= 0]
        need = np.array(pk.strip_words)[mine[:, 0]]
        assert (mine[:, 2] == np.cumsum(need) - need).all()
        used.append(int(need.sum()))
    assert pk.smem_bytes == 4 * max(used)
    assert pk.holds(groups) and not pk.holds(groups[::-1])
    one = rd.DirectPacking(groups, per_block=1)
    assert (one.blocks[:, 1:, 0] == -1).all() and (one.blocks[:, 0, 2] == 0).all()


def test_column_carry_takes_its_words():
    """vdd's and pdd's column carry takes cw * 128 u16 of shared memory a
    strip, at any chunk count; zzd's row prefix takes none."""
    plan = _fixture_plan(paths=FIXTURES[:1])
    fn, ops, kw = plan._direct_groups[0]
    kw = {k: v for k, v in kw.items() if k != "pdd_ws"}
    base = rd.DirectPacking([(fn, ops, dict(kw, vdd_ws=0))]).strip_words[0]
    for cw in (1, 3, 8, 12):
        pk = rd.DirectPacking([(fn, ops, dict(kw, vdd_ws=0, pdd_ws=cw))])
        assert pk.strip_words[0] == base + 64 * cw and pk.desc["arg"][0, 6:8].tolist() == [3, cw]
    for vws in (1, 2, 4, 8):
        pk = rd.DirectPacking([(fn, ops, dict(kw, vdd_ws=vws))])
        assert pk.strip_words[0] == base + 64 * vws and pk.desc["arg"][0, 6:8].tolist() == [2, vws]


def test_groups_reject_bad_arguments():
    plan = _fixture_plan(paths=FIXTURES[:2])
    groups = plan._direct_groups
    fn, ops, kw = groups[0]
    with pytest.raises(ValueError):  # the route is not picked from the first group alone
        rd.rans_decode_direct_groups([groups[0], (fn, tuple(o.to("meta") for o in ops), kw)])
    with pytest.raises(ValueError):
        rd.DirectPacking([groups[0], (fn, tuple(o.to("meta") for o in ops), kw)])
    bad = [dict(kw, pdd_ws=2, vdd_ws=2), dict(kw, pdd_ws=-1), dict(kw, pdd_ws=2.0),
           dict(kw, dense=True), dict(kw, vdd_ws=3)]
    for b in bad:
        with pytest.raises(ValueError):
            rd.DirectPacking([(fn, ops, b)])
        with pytest.raises(ValueError):
            rd.rans_decode_direct_groups([(fn, ops, b)])
    afn, aops, akw = [g for g in groups if g[0] is rd.rans_decode_alias][0]
    with pytest.raises(ValueError):
        rd.DirectPacking([(afn, aops, dict(akw, fused=False, pdd_ws=2))])
    with pytest.raises(ValueError):
        rd.DirectPacking([(rd.rans_decode_rle, ops, kw)])
    with pytest.raises(ValueError):
        rd.DirectPacking([])
    for per in (0, 5):
        with pytest.raises(ValueError):
            rd.DirectPacking(groups, per_block=per)
    with pytest.raises(ValueError):  # a carry past a block's shared memory
        rd.DirectPacking([(fn, ops, dict(kw, vdd_ws=0, pdd_ws=1 << 12))])
    assert rd.rans_decode_direct_groups([]) == []


def test_bucket_packing_kept_for_the_same_tensors():
    """A one-bucket wrapper reuses its last packing only for the very
    tensors and arguments it was built for."""
    plan = _fixture_plan(paths=FIXTURES[:2])
    b0, b1 = list(plan.buckets.values())[:2]
    fn, ops, kw = b0.fn, b0.ops, b0.kwargs
    first = rd._bucket_packing(fn, ops, kw)
    assert isinstance(first, rd.DirectPacking)
    assert rd._bucket_packing(fn, ops, dict(kw)) is first
    assert first.holds([(fn, ops, kw)]) and "pdd_ws" not in first.groups[0][2]
    other = rd._bucket_packing(fn, ops, dict(kw, vdd_ws=1))
    assert other is not first and other.desc["arg"][0, 6:8].tolist() == [2, 1]
    copies = tuple(o.clone() for o in ops)
    assert rd._bucket_packing(fn, copies, kw) is not other


def test_wrappers_on_cpu_count_no_launch():
    plan = _fixture_plan(paths=FIXTURES[:2])
    before = (rd.rans_decode_direct_groups.launches,
              dict(rd.rans_decode_direct_groups.family_launches),
              rd.rans_decode_zzd.launches, rd.rans_decode_alias.launches)
    plan.run()
    for b in plan.buckets.values():
        b()
    assert before == (rd.rans_decode_direct_groups.launches,
                      rd.rans_decode_direct_groups.family_launches,
                      rd.rans_decode_zzd.launches, rd.rans_decode_alias.launches)


def _ballot_ranks(need: torch.Tensor, layout: str):
    """A torch mirror of the kernel's warp_ranks over a strip's 128 need
    flags (bool [128]): 32 threads, 4 lanes each, four ballots; returns
    (rank of each lane, the count)."""
    t = torch.arange(32)
    lane = t[:, None] * 4 + torch.arange(4) if layout == "contiguous" else \
        t[:, None] + 32 * torch.arange(4)
    f = need[lane].to(torch.int64)  # [thread, k]
    ballots = [(f[:, k] << t).sum() for k in range(4)]
    lt = (1 << t) - 1

    def popc(v):
        return torch.tensor([bin(int(x)).count("1") for x in v.reshape(-1)]).reshape(v.shape)

    ranks = torch.zeros(128, dtype=torch.int64)
    if layout == "contiguous":
        below = sum(popc(b & lt) for b in ballots)
        own = torch.cumsum(f, dim=1) - f
        ranks[lane] = below[:, None] + own
    else:
        run = 0
        for k, b in enumerate(ballots):
            ranks[lane[:, k]] = run + popc(b & lt)
            run += bin(int(b)).count("1")
    return ranks, sum(bin(int(b)).count("1") for b in ballots)


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("p", [0.0, 0.3, 0.7, 1.0])
def test_ballot_ranks_mirror_the_exclusive_cumsum(layout, p):
    rng = np.random.default_rng(int(p * 10) + (layout == "strided"))
    need = torch.from_numpy(rng.random(128) < p)
    ranks, count = _ballot_ranks(need, layout)
    n = need.to(torch.int64)
    assert torch.equal(ranks[need], (torch.cumsum(n, 0) - n)[need])
    assert count == int(n.sum())


# ---------------------------------------------------------------------------
# CUDA kernel vs its plain twin (on the card; skipped elsewhere)
# ---------------------------------------------------------------------------

FORMS = {"contiguous": (), "strided": ("-DMIC_DIRECT_LAYOUT=1",),
         "block128": ("-DMIC_DIRECT_TEAM=128",), "noring": ("-DMIC_DIRECT_RING=0",)}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _extra_groups(groups):
    """More groups on the operands of a plan's: FF 57 pdd at 3 and 12
    chunks a row and vdd at 8, FF 41 symbols."""
    def own(kw):
        return {k: v for k, v in kw.items() if k != "pdd_ws"}

    fn, ops, kw = [g for g in groups if g[0] is rd.rans_decode_zzd][0]
    extra = [(fn, ops, dict(own(kw), vdd_ws=0, pdd_ws=cw)) for cw in (3, 12)]
    extra.append((fn, ops, dict(own(kw), vdd_ws=8)))
    afn, aops, akw = [g for g in groups if g[0] is rd.rans_decode_alias][0]
    extra.append((afn, aops, dict(own(akw), vdd_ws=0, fused=False)))
    return extra


def test_extra_groups_pack():
    """The CUDA test's extra groups are valid groups of one packing."""
    groups = _fixture_plan()._direct_groups
    pk = rd.DirectPacking(groups + _extra_groups(groups))
    assert [d[6:8] for d in pk.desc["arg"][-4:].tolist()] == [[3, 3], [3, 12], [2, 8], [0, 0]]


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
def test_cuda_groups_match_plain(form):
    """Every direct bucket of the fixtures in one launch, with pdd fused,
    plus pdd at 3 and 12 chunks a row, vdd at 8 and FF 41 symbols, four
    strips a block and one, kernel == plain on whole arrays, in each form
    of the kernel."""
    from mic_tpu_torch._build import kernel_library

    dev = _need_cuda()
    plan = _fixture_plan(dev, FIXTURES + [TESTDATA / "CT_dev.micw"])
    groups = plan._direct_groups
    extra = _extra_groups(groups)
    lib = kernel_library(FORMS[form])
    want = rd.rans_decode_direct_groups_plain(groups + extra)
    for pk in (rd.DirectPacking(groups + extra), rd.DirectPacking(groups + extra, per_block=1)):
        got = rd._direct_launch(pk, lib)
        torch.cuda.synchronize()
        for g, w, (f, _o, k) in zip(got, want, groups + extra):
            assert torch.equal(g, w), (form, f.__name__, k)


@pytest.mark.cuda
def test_cuda_plan_and_wrappers_count_their_launches():
    dev = _need_cuda()
    plan = _fixture_plan(dev)
    raws = [np.fromfile(TESTDATA / n, dtype="<u2")
            for n in ("MR_dev.raw", "MR_dev_alias.raw", "wide_banded.raw", "CT_dev.raw")]
    with pytest.raises(ValueError):
        rd.rans_decode_direct_groups(plan._direct_groups,
                                     rd.DirectPacking(plan._direct_groups[::-1]))
    before = rd.rans_decode_direct_groups.launches
    fam = dict(rd.rans_decode_direct_groups.family_launches)
    run = plan.run()
    torch.cuda.synchronize()
    assert rd.rans_decode_direct_groups.launches == before + 1
    held = {"rans_decode_zzd", "rans_decode_alias"}  # the direct front ends; no post strips
    assert all(rd.rans_decode_direct_groups.family_launches[n] == fam[n] + (n in held)
               for n in fam)
    assert plan.verify_batch(run, raws) == 0
    for b in plan.buckets.values():
        n = b.fn.launches
        got = b.fn(*b.ops, **b.kwargs)
        torch.cuda.synchronize()
        assert b.fn.launches == n + 1
        assert torch.equal(got, rd._DIRECT_PLAIN[b.fn](*b.ops, **b.kwargs))


@pytest.mark.cuda
def test_cuda_corrupt_streams_through_the_merged_launch():
    """The corrupted streams of test_torch_corruption.py (the direct
    fixtures) through the merged launch: in bounds, and equal to the plain
    twin."""
    from test_torch_corruption import CASES, _corrupt

    dev = _need_cuda()
    checked = 0
    for name, kind in CASES:
        if name not in ("MR_dev.micw", "MR_dev_alias.micw"):
            continue
        try:
            plan = MicwDecodePlan([_corrupt(name, kind)], dev)
        except (ValueError, NotImplementedError):
            continue
        got = rd.rans_decode_direct_groups(plan._direct_groups, plan.direct_packing)
        torch.cuda.synchronize()
        for g, w in zip(got, rd.rans_decode_direct_groups_plain(plan._direct_groups)):
            assert torch.equal(g, w), (name, kind)
        checked += 1
    assert checked
