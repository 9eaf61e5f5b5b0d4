"""The lanes kernel's fused form: the scan tier's direct modes (zzd, vdd,
pdd) decoded and inverted in one kernel, against mic_tpu.

Tolerance 0 everywhere: a lossless codec, whole arrays compared.

* ``decode_strip_batch`` (the fused plain twin on the CPU) against
  ``mic_tpu``'s ``decode_strip_batch_impl``, the graft entry's step, on
  whole arrays: zzd, vdd and pdd at 8, 32, 64 and 256 lanes, FF 57 and FF
  41 with escapes in one batch, a short last strip whose padding columns
  are the inverse of its inactive lanes' symbols.
* The fused twin against ``post.post_batch`` on the symbols-out twin,
  where the steps cover less than width * strip_h (a bucket of short
  strips: zero padding, then the inverse).
* ``MicwDecodePlan`` routing: the direct modes fused (no post stage), a
  width that is not a multiple of the lanes, zz and the r-modes, and
  strips past ``WARP_LANES`` through ``post_batch``; every plan against
  ``micw_decompress_host``; ``post_batch.calls`` counts the post stages.

The ``cuda`` tests hold the kernel to the plain twin on the card, in
both forms; they skip without a GPU.  ``mic_tpu`` is imported through the
``ref`` fixture: the machine with the card has no jax.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mic_tpu_torch.tpu import device_rans as dr
from mic_tpu_torch.tpu import post
from mic_tpu_torch.tpu import scan_decode as sd
from mic_tpu_torch.tpu import strips as st
from test_torch_scan_decode import encode_at

CPU = torch.device("cpu")
MODES = {"zzd": st.STRIP_MODE_ZZD, "vdd": st.STRIP_MODE_VDD, "pdd": st.STRIP_MODE_PDD}


@pytest.fixture(scope="module")
def ref():
    """mic_tpu's scan tier and host decoder (needs jax)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from mic_tpu.tpu import strips

    return SimpleNamespace(jnp=jnp, st=strips)


def _image(seed, h, w, spikes=0.02):
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((h, w)).cumsum(axis=1) * 60 + 2000).clip(0, 4095)
    img = img.astype(np.uint16)
    img[rng.random((h, w)) < spikes] = 4000
    return img


def _strip_streams(img, pred, strip_h, lanes, tl=11):
    """Each strip of ``img`` (the last one short) as its direct-mode
    symbols, encoded at exactly ``tl`` and ``lanes`` (``encode_at``): FF
    57, then FF 41 (with escapes) for the same strips.  Returns (parsed,
    strips), ``build_strip_batch``'s arguments."""
    h, w = img.shape
    parsed, strips = [], []
    for alias in (False, True):
        for y in range(0, h, strip_h):
            rows = img[y:y + strip_h]
            syms = st._DIRECT_SYMS[pred](rows.ravel(), w, rows.shape[0])
            blob = encode_at(dr, syms, tl, lanes, alias=alias)
            p = dr.mict_parse(blob)
            assert np.array_equal(dr.mict_decode_numpy(blob), syms)
            parsed.append(p)
            strips.append((blob, p[2], p[2], 0, 0, MODES[pred]))
    assert any(p[7] is not None and len(p[7][1]) for p in parsed)  # escapes
    return parsed, strips


@pytest.mark.parametrize("lanes", [8, 32, 64, 256])
def test_fused_twin_matches_graft_step(ref, lanes):
    """Three strips of 256 x 10 (the last one 2 rows of a 4-row bucket),
    FF 57 and FF 41, each direct mode: ``decode_strip_batch`` fuses the
    inverse and equals ``decode_strip_batch_impl`` on whole arrays."""
    img = _image(lanes, 10, 256)
    for pred in MODES:
        parsed, strips = _strip_streams(img, pred, 4, lanes)
        arrays, meta = ref.st.build_strip_batch(parsed, strips, 11)
        kw = dict(table_log=11, n_steps=meta["n_steps"], width=256, strip_h=4,
                  max_runs=meta["max_runs"], max_tokens=meta["max_tokens"], mid_count=0,
                  delim=0, predictor=pred)
        assert sd.fused_strip_fits(lanes, pred, 256, True)
        calls = post.post_batch.calls
        got = sd.decode_strip_batch(*arrays, **kw, device=CPU)
        assert post.post_batch.calls == calls  # fused: no post stage
        want = np.asarray(ref.st._decode_strip_batch(*[ref.jnp.asarray(a) for a in arrays],
                                                     **kw))
        assert got.shape == want.shape == (6, 1024)
        assert np.array_equal(got.numpy().view(np.uint16), want), pred
        for i in (0, 3):  # a full strip of each family
            assert np.array_equal(want[i], img[:4].ravel())
        assert np.array_equal(want[2][:512], img[8:].ravel())


@pytest.mark.parametrize("pred", sorted(MODES))
def test_fused_twin_pads_short_steps(pred):
    """A bucket whose steps cover less than width * strip_h (its strips
    all short): the fused twin equals ``post_batch`` on the symbols-out
    twin, the symbols zero-padded before the inverse."""
    img = _image(3, 6, 128)
    parsed, _strips = _strip_streams(img, pred, 6, 32)
    built = sd.build_lane_tables(parsed)
    ops = sd.lane_tensors(built[:10], CPU)
    steps = built[10]
    assert steps * 32 < 128 * 16
    syms = sd.rans_decode_lanes_plain(*ops, steps=steps)
    n = torch.zeros(len(parsed), dtype=torch.int64)
    want = post.post_batch(syms, n, n, n, width=128, strip_h=16, max_runs=128,
                           max_tokens=128, mid_count=0, delim=0, predictor=pred)
    got = sd.rans_decode_lanes(*ops, steps=steps, inverse=pred, width=128, strip_h=16)
    assert got.shape == (len(parsed), 2048) and torch.equal(got, want)
    assert np.array_equal(got[0, :768].numpy().view(np.uint16), img.ravel())
    with pytest.raises(ValueError, match="multiple"):
        sd.rans_decode_lanes(*ops, steps=steps, inverse=pred, width=80, strip_h=16)


def test_plan_routing_and_packing(ref):
    """Which scan buckets a plan fuses, and the warp form's packing: teams
    a block, shared bytes a block, one launch a form."""
    img = _image(5, 48, 192, spikes=0.01)
    px, mx = img.ravel(), int(img.max())
    blobs = {
        "zzd_l64": st.micw_compress(px, 192, 48, mx, lanes=64, predictor="zzd"),
        "pdd_l32": st.micw_compress(px, 192, 48, mx, lanes=32, predictor="pdd",
                                    entropy="alias"),
        "pdd_l64_w160": st.micw_compress(img[:, :160].ravel(), 160, 48, mx, lanes=64,
                                         predictor="pdd"),  # 160 % 64
        "zz_l64": st.micw_compress(px, 192, 48, mx, lanes=64, predictor="zz"),
        "zzr_l64": st.micw_compress(px, 192, 48, mx, lanes=64, predictor="zzr"),
        "zzd_l1024": st.micw_compress(np.tile(img, (1, 6))[:, :1088].ravel(), 1088, 48, mx,
                                      lanes=1024, num_strips=1, predictor="zzd"),
    }
    plan = st.MicwDecodePlan(list(blobs.values()), CPU)
    fused = {k[3]: (k[1], k[4]) for k, b in plan.buckets.items()
             if k[0] == "scan" and b.post is None}
    unfused = {(k[1], k[3], k[4]) for k, b in plan.buckets.items()
               if k[0] == "scan" and b.post is not None}
    assert all(k[0] == "scan" for k in plan.buckets)
    assert fused.keys() <= set(MODES) and ("zzd", 64) not in unfused
    assert all(w % L == 0 and L <= sd.WARP_LANES for L, w in fused.values())
    assert (64, "pdd", 160) in unfused  # 160 is no multiple of 64 lanes
    assert any(L == 1024 for L, _p, _w in unfused)  # past the warp form: symbols out
    assert {"zz", "zzr"} <= {p for _L, p, _w in unfused}
    calls = post.post_batch.calls
    decoded = plan.run()
    assert post.post_batch.calls - calls == len(unfused)
    want = [np.asarray(ref.st.micw_decompress_host(b)[0]).ravel() for b in blobs.values()]
    assert np.array_equal(want[0], px) and np.array_equal(want[2], img[:, :160].ravel())
    assert plan.verify_batch(decoded, want) == 0
    for (out, _w, _h), w in zip(plan.assemble(decoded), want):
        assert np.array_equal(out, w)

    pk = sd.LanesPacking(plan._scan_groups)
    assert pk.n_launches == 2 and pk.teams.shape[1:] == (sd.TEAMS, 3)
    live = pk.teams[pk.teams[:, :, 0] >= 0]
    n_warp = sum(ops[0].shape[0] for _f, ops, _k in plan._scan_groups
                 if ops[0].shape[1] <= sd.WARP_LANES)
    assert len(live) == n_warp and len(pk.blocks) == plan.buckets[
        next(k for k in plan.buckets if k[1] == 1024)].n
    assert (pk.teams[:, :n_warp, 0] >= 0).all() or len(pk.teams) > 1
    # a block's teams at consecutive byte offsets, each its strip's bytes
    for block in pk.teams:
        at = 0
        for g, _s, off in block:
            if g < 0:
                continue
            assert off == at
            at += pk.team_bytes[g]
        assert at <= pk.smem_bytes
    L, inv, width, esc = (int(pk.desc["arg"][0][i]) for i in (0, 5, 8, 11))
    assert pk.team_bytes[0] == sd._team_bytes(L, bool(esc), inv, width,
                                              bool(pk.desc["alias"][0]))
    assert sd._team_bytes(64, True, 3, 512) == 16 * 64 + 2048 + 1024
    assert pk.smem_bytes == max(sum(pk.team_bytes[g] for g, *_r in b if g >= 0)
                                for b in pk.teams)
    # every strip in the block form
    all_wide = sd.LanesPacking([(fn, ops, {"steps": kw["steps"]})
                                for fn, ops, kw in plan._scan_groups], warp_lanes=0)
    assert all_wide.n_launches == 1 and len(all_wide.teams) == 0
    with pytest.raises(ValueError, match="warp form"):
        sd.LanesPacking(plan._scan_groups, warp_lanes=0)
    # past the warp form, or a carry too wide for any block: unfused
    assert not sd.fused_strip_fits(2 * sd.WARP_LANES, "zzd", 4 * sd.WARP_LANES, False)
    assert not sd.fused_strip_fits(64, "pdd", 1 << 17, False)
    assert sd.fused_strip_fits(64, "zzd", 1 << 17, False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8, 32, 64, 128, 256, 512])
def test_cuda_fused_kernel_matches_plain(cuda, lanes):
    """Both direct families, all three inverses, a short last strip and a
    bucket of short strips; each in the warp form (fused and symbols out)
    and the block form (symbols out), against the plain twin."""
    width = max(256, lanes)
    img = _image(lanes, 10, width)
    for pred in MODES:
        parsed, _s = _strip_streams(img, pred, 4, lanes)
        built = sd.build_lane_tables(parsed)
        ops = sd.lane_tensors(built[:10], CPU)
        steps = built[10]
        ops_d = tuple(t.to(cuda) for t in ops)
        for strip_h in (4, 8):  # 8: steps * L < width * strip_h
            want = sd.rans_decode_lanes_plain(*ops, steps=steps, inverse=pred, width=width,
                                              strip_h=strip_h)
            got = sd.rans_decode_lanes(*ops_d, steps=steps, inverse=pred, width=width,
                                       strip_h=strip_h)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (pred, strip_h)
        sym = sd.rans_decode_lanes_plain(*ops, steps=steps)
        for warp_lanes in (sd.WARP_LANES, 0):
            pk = sd.LanesPacking([(sd.rans_decode_lanes, ops_d, {"steps": steps})],
                                 warp_lanes=warp_lanes)
            (got,) = sd._lanes_launch(pk)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), sym), (pred, warp_lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8, 32, 64, 512])
def test_cuda_fused_bucket_front_end_matches_plain(cuda, lanes):
    """The FF 41 strips through their bucket tables (``build_lane_operands``,
    FF 57 strips in the same bucket through their slot tables), fused with
    each inverse and symbols out, against the plain twin; the plan's
    bucket counter names the FF 41 strips."""
    width = max(256, lanes)
    img = _image(lanes + 1, 10, width)
    for pred in MODES:
        parsed, _s = _strip_streams(img, pred, 4, lanes, tl=12)
        built = sd.build_lane_operands(parsed)
        assert (built[11] >= 0).sum() == len(parsed) // 2  # the FF 41 half
        ops = sd.lane_tensors(built[:12], CPU)
        steps = built[12]
        ops_d = tuple(t.to(cuda) for t in ops)
        for strip_h in (4, 8):
            want = sd.rans_decode_lanes_plain(*ops, steps=steps, inverse=pred, width=width,
                                              strip_h=strip_h)
            got = sd.rans_decode_lanes(*ops_d, steps=steps, inverse=pred, width=width,
                                       strip_h=strip_h)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (pred, strip_h)
        got = sd.rans_decode_lanes(*ops_d, steps=steps)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), sd.rans_decode_lanes_plain(*ops, steps=steps)), pred
