"""``MicwDecodePlan.make_timed_runner`` (``mic_tpu_torch/tpu/strips.py``)
against ``verify_batch`` and ``mic_tpu``'s runner.

One small mixed batch, replicated x3: a zzd FF 57 container, an FF 41
one with a short last strip, one whose second strip is constant, and a
64-lane one (the scan
tier), all encoded by the port's host encoder from seeded images.  The
runner's mismatch count must be exact (0 with the true pixels, k with k
flipped pixels, equal to ``verify_batch``'s), its probe the sum over the
runs of each bucket's ``out[0, :8]``, and a flipped pixel of the constant
strip must make it None.  ``mic_tpu``'s runner returns None for a batch
with a blob of another lane count than 128 (its fallback), so the
cross-package counts are taken on the three 128-lane containers.

The compare itself (``mic_tpu_torch/tpu/verify.py``) is held to the form
the runner had before it took per-row valid lengths (the expected rows
of every output row, a bool mask of each row's valid pixels): the plain
twin on seeded rows of mixed valid lengths, row maps and flips, and the
packing's lengths, row maps and compare blocks against those masks.

The ``cuda`` test runs the runner on the card, and the compare kernel
against its plain twin there; it needs no jax.
"""

import numpy as np
import pytest
import torch

from mic_tpu_torch import MicwDecodePlan
from mic_tpu_torch.tpu import verify
from mic_tpu_torch.tpu.strips import STRIP_MODE_CONST, micw_compress, micw_parse

CPU = torch.device("cpu")
REPS = 3


def _images():
    rng = np.random.default_rng(3)

    def smooth(h, w):
        img = rng.standard_normal((h, w)).cumsum(axis=1) * 9 + 700
        return img.clip(0, 4095).astype(np.uint16)

    const = smooth(16, 128)
    const[8:] = 555
    # the FF 41 image's second strip is short (7 of 8 rows): its row is
    # compared over its valid pixels only
    return [(smooth(16, 128), "standard", 128), (smooth(15, 128), "alias", 128),
            (const, "standard", 128), (smooth(16, 128), "standard", 64)]


@pytest.fixture(scope="module")
def batch():
    """(blobs, expected pixels), each container x3, blob after blob."""
    blobs, expected = [], []
    for px, entropy, lanes in _images():
        blob = micw_compress(px.ravel(), 128, px.shape[0], int(px.max()), num_strips=2,
                             lanes=lanes, predictor="zzd", entropy=entropy)
        blobs += [blob] * REPS
        expected += [px.ravel()] * REPS
    assert micw_parse(blobs[2 * REPS])[7][1][5] == STRIP_MODE_CONST
    return blobs, expected


def _flipped(expected, picks):
    """Copies of ``expected`` with one pixel flipped per (blob, index)."""
    out = [e.copy() for e in expected]
    for bi, i in picks:
        out[bi][i] ^= 1
    return out


# (blob, pixel) flips inside entropy-coded strips: FF 57, FF 41's short
# strip (its last pixel), the entropy strip beside the constant one, the
# 64-lane strip
FLIPS = [(0, 5), (4, 15 * 128 - 1), (7, 3), (10, 2047)]
# 300 more, drawn from every blob's entropy-coded pixels (blobs 6-8 hold
# their constant strip in pixels 1024 on)
_RNG = np.random.default_rng(11)
MANY = sorted({(int(b), int(_RNG.integers(0, 1024 if 2 * REPS <= b < 3 * REPS
                                          else (15 if REPS <= b < 2 * REPS else 16) * 128)))
               for b in _RNG.integers(0, 4 * REPS, 300)} | set(FLIPS))


def _picks(k):
    return MANY if k == "many" else FLIPS[:k]


def _run(device, blobs, expected):
    plan = MicwDecodePlan(blobs, device)
    runner = plan.make_timed_runner(expected)
    mism, probe = runner(REPS)
    assert mism.device.type == probe.device.type == plan.device.type
    assert mism.dim() == probe.dim() == 0
    return plan, runner, int(mism), int(probe)


def test_runner_true_pixels(batch):
    assert _run(CPU, *batch)[2] == 0


@pytest.mark.parametrize("k", [1, 2, 4, "many"])
def test_runner_counts_flipped_pixels(batch, k):
    blobs, expected = batch
    bad = _flipped(expected, _picks(k))
    plan, _runner, mism, _probe = _run(CPU, blobs, bad)
    assert mism == len(_picks(k)) == plan.verify_batch(plan.run(), bad)


def test_runner_probe_sums_first_values(batch):
    """The probe as the runner summed it before the compare took one
    call: the first values of every bucket concatenated, cast, masked."""
    plan, _runner, _mism, probe = _run(CPU, *batch)
    firsts = torch.cat([out[0, :8] for out in plan.run().values()])
    assert probe == REPS * int((firsts.to(torch.int64) & 0xFFFF).sum())


def _distinct_rows(packing):
    return [None if e is None else e[1].numel() for e in packing.expected]


@pytest.mark.parametrize("blob", [0, REPS, 3 * REPS])
def test_runner_tiles_a_replicated_blob(batch, blob):
    """One blob x3 with one expected object (FF 57, FF 41 with a short
    strip, 64 lanes): its expected rows are staged once, each replica's
    rows mapped onto them, and a flip counts once a replica, as with the
    same pixels in three distinct objects (staged three times)."""
    blobs, expected = batch
    bad = _flipped(expected[blob:blob + 1], [(0, 7), (0, 15 * 128 - 1)])[0]
    plan, runner, mism, _probe = _run(CPU, blobs[blob:blob + 1] * REPS, [bad] * REPS)
    assert mism == 2 * REPS == plan.verify_batch(plan.run(), [bad] * REPS)
    assert _distinct_rows(runner.packing) == [S // REPS for S in runner.packing.rows]
    for _exp, _valid, rowmap in runner.packing.expected:
        assert rowmap.tolist() == list(range(rowmap.numel() // REPS)) * REPS
    copies = [bad.copy() for _ in range(REPS)]
    _plan, distinct, mism_d, _p = _run(CPU, blobs[blob:blob + 1] * REPS, copies)
    assert mism_d == mism and _distinct_rows(distinct.packing) == distinct.packing.rows


def test_runner_none_on_a_wrong_constant_strip(batch):
    blobs, expected = batch
    bad = _flipped(expected, [(2 * REPS, 128 * 8 + 9)])  # the constant strip's rows
    assert MicwDecodePlan(blobs, CPU).make_timed_runner(bad) is None


def test_runner_matches_mic_tpu(batch):
    """Both runners on the 128-lane containers: the same mismatch counts
    (and None for the wrong constant strip), and ``mic_tpu``'s None for a
    batch with a 64-lane blob."""
    pytest.importorskip("jax")
    from mic_tpu.tpu.strips import MicwDecodePlan as RefPlan

    blobs, expected = batch
    n = 3 * REPS
    ref = RefPlan(blobs[:n])
    for picks in ([], FLIPS[:3], [f for f in MANY if f[0] < n]):
        exp = _flipped(expected[:n], picks)
        want, _p = ref.make_timed_runner(exp)(REPS)
        assert _run(CPU, blobs[:n], exp)[2] == int(want) == len(picks)
    bad = _flipped(expected[:n], [(2 * REPS, 128 * 8 + 9)])
    assert ref.make_timed_runner(bad) is None
    assert MicwDecodePlan(blobs[:n], CPU).make_timed_runner(bad) is None
    assert RefPlan(blobs).make_timed_runner(expected) is None


def _old_expected_rows(rows: dict, n_rows: int):
    """The runner's staging before per-row lengths: the expected rows
    (u16 [n_rows, cols]) and None where every row is full, else the bool
    mask of each row's valid pixels."""
    cols = max(len(s) for s in rows.values())
    exp = np.zeros((n_rows, cols), np.uint16)
    valid = np.zeros((n_rows, 1), np.int64)
    for i, s in rows.items():
        if i < n_rows:
            exp[i, : len(s)] = s
            valid[i, 0] = len(s)
    return exp, None if (valid == cols).all() else np.arange(cols)[None, :] < valid


@pytest.mark.parametrize("replicated", [False, True])
def test_packing_lengths_match_the_masks(batch, replicated):
    """The runner's packing against the masks of the former staging: each
    bucket's distinct expected rows through its row map give the same
    expected rows, its lengths the same mask, and its compare blocks cover
    exactly the mask's pixels, in chunks of at most CHUNK; a blob object
    repeated with one expected object is staged once (the batch repeats
    each container x3)."""
    blobs, expected = batch
    if replicated:
        blobs, expected = blobs[:1] * REPS, expected[:1] * REPS
    plan = MicwDecodePlan(blobs, CPU)
    packing = plan.make_timed_runner(expected).packing
    _host, segs = plan._segments(dict(enumerate(expected)))
    blocks = packing.blocks
    assert packing.parts == [(0, len(plan.buckets), 0, len(blocks))]
    for g, (key, b) in enumerate(plan.buckets.items()):
        exp_old, mask_old = _old_expected_rows(segs[key], b.n)
        exp, valid, rowmap = (t.numpy() for t in packing.expected[g])
        assert valid.size == b.n // REPS
        assert np.array_equal(exp.view(np.uint16)[rowmap], exp_old)
        mask = np.arange(exp.shape[1])[None, :] < valid[rowmap][:, None]
        assert np.array_equal(mask, np.ones_like(mask) if mask_old is None else mask_old)
        mine = blocks[blocks[:, 0] == g]
        assert (mine[:, 3] - mine[:, 2] <= verify.CHUNK).all() and (mine[:, 2] % 8 == 0).all()
        covered = np.zeros_like(mask)
        for _g, r, c0, c1 in mine:
            assert not covered[r, c0:c1].any()
            covered[r, c0:c1] = True
        assert np.array_equal(covered, mask)


def _mask_form(out, exp, mask):
    """The former compare: ``(out != exp) & mask`` summed, the expected
    rows and the bool mask of each row's valid pixels at the output's
    rows."""
    return int(((out[:, :exp.shape[1]] != exp) & mask).sum())


@pytest.mark.parametrize("distinct,reps,mapping", [(7, 1, "identity"), (7, 3, "replicas"),
                                                   (1, 5, "replicas"), (7, 3, "random")])
@pytest.mark.parametrize("flips", [0, 1, 200])
def test_plain_twin_matches_the_mask_form(distinct, reps, mapping, flips):
    """Seeded rows of mixed valid lengths (0 and full among them), u16
    values with the top bit set, outputs wider than the expected rows and
    at a row stride of their own, row maps that repeat the expected rows
    replica by replica or at random, flips inside and outside the valid
    pixels: the twin, the former masked compare and a numpy count agree;
    the probe is each output's ``out[0, :8]`` as u16 values."""
    rng = np.random.default_rng(distinct * 100 + reps * 10 + flips)
    cols, width, S = 37, 45, distinct * reps
    valid = rng.integers(0, cols + 1, distinct).astype(np.int32)
    valid[0] = cols
    valid[-1] = 0 if distinct > 1 else valid[-1]
    exp = rng.integers(0, 1 << 16, (distinct, cols), dtype=np.uint16)
    rowmap = (rng.integers(0, distinct, S) if mapping == "random"
              else np.tile(np.arange(distinct), reps)).astype(np.int32)
    rowmap[0] = 0  # the forced flip's row is full
    parent = rng.integers(0, 1 << 16, (S, width + 3), dtype=np.uint16)
    parent[:, :cols] = exp[rowmap]
    for i, f in enumerate(rng.integers(0, S * cols, flips)):
        r, c = (0, 3) if i == 0 else divmod(int(f), cols)
        parent[r, c] ^= 1 << int(rng.integers(0, 16))
    truth = sum(int(np.count_nonzero(parent[r, :n] != exp[rowmap[r], :n]))
                for r in range(S) for n in [valid[rowmap[r]]])
    out = torch.from_numpy(parent.view(np.int16))[:, :width]
    exp_t, valid_t = torch.from_numpy(exp.view(np.int16)), torch.from_numpy(valid)
    map_t = torch.from_numpy(rowmap)
    got = verify.bucket_mismatches_plain(out, exp_t, valid_t, map_t)
    assert got.dim() == 0 and got.dtype == torch.int64
    mask = torch.arange(cols)[None, :] < valid_t[map_t.long()][:, None]
    assert int(got) == _mask_form(out, exp_t[map_t.long()], mask) == truth
    assert (truth > 0) == (flips > 0)
    if mapping == "identity":
        assert int(verify.bucket_mismatches_plain(out, exp_t, valid_t)) == truth
    packing = verify.MismatchPacking([S], [(exp, valid, rowmap)], CPU)
    acc = torch.zeros(2, dtype=torch.int64)
    verify.count_mismatches(packing, [out], acc)
    assert acc.tolist() == [truth, int(parent[0, :8].astype(np.int64).sum())]


def test_packing_splits_launches_and_checks_outputs():
    """Past MAX_GROUPS buckets the packing makes a launch of each
    MAX_GROUPS, its blocks' group numbers counted from the launch's
    first; buckets with no expected rows get no block; the wrapper
    refuses outputs the kernel does not take."""
    n = verify.MAX_GROUPS + 2
    valid = np.array([3, verify.CHUNK + 5], np.int32)
    exp = np.zeros((2, verify.CHUNK + 5), np.uint16)
    rowmap = np.array([0, 1, 0, 1], np.int32)
    staged = [None if g % 7 == 3 else (exp, valid, rowmap) for g in range(n)]
    packing = verify.MismatchPacking([4] * n, staged, CPU)
    per = 2 * (1 + 2)  # each row pair: one chunk, then two
    kept = [g for g in range(n) if staged[g] is not None]
    first = sum(1 for g in kept if g < verify.MAX_GROUPS) * per
    assert packing.parts == [(0, verify.MAX_GROUPS, 0, first),
                             (verify.MAX_GROUPS, n, first, len(kept) * per)]
    assert set(packing.blocks[first:, 0]) == {g - verify.MAX_GROUPS for g in kept
                                              if g >= verify.MAX_GROUPS}
    assert packing.expected[3] is None
    with pytest.raises(ValueError):
        verify.MismatchPacking([4], [(exp, valid, np.array([0, 1, 2, 0], np.int32))], CPU)
    outs = [torch.zeros((4, verify.CHUNK + 5), dtype=torch.int16) for _ in range(n)]
    acc = torch.zeros(2, dtype=torch.int64)
    verify.count_mismatches(packing, outs, acc)
    assert acc.tolist() == [0, 0]
    for bad in (outs[0].to(torch.int32), outs[0][:3], outs[0][:, :9],
                torch.zeros((verify.CHUNK + 5, 4), dtype=torch.int16).t()):
        with pytest.raises(ValueError):
            verify.count_mismatches(packing, [bad] + outs[1:], acc)
    with pytest.raises(ValueError):
        verify.count_mismatches(packing, outs, torch.zeros(2, dtype=torch.int32))


@pytest.mark.cuda
def test_cuda_runner_counts_like_the_cpu(batch):
    """On the card: the runner's counts and probe equal the CPU's, and the
    compare kernel equals its plain twin on one run's outputs, clean and
    flipped, compare and probe alone, distinct and replicated batches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    blobs, expected = batch
    cases = [(blobs, _flipped(expected, picks), len(picks)) for picks in ([], FLIPS, MANY)]
    rep = _flipped(expected[:1], [(0, 7)])[0]
    cases.append((blobs[:1] * REPS, [rep] * REPS, REPS))
    for blobs_c, exp, n_bad in cases:
        plan, runner, mism, probe = _run(cuda, blobs_c, exp)
        assert mism == n_bad == plan.verify_batch(plan.run(), exp)
        assert probe == _run(CPU, blobs_c, exp)[3]
        outs = list(plan.run().values())
        for compare in (True, False):
            got = torch.zeros(2, dtype=torch.int64, device=cuda)
            want = torch.zeros(2, dtype=torch.int64, device=cuda)
            before = verify.count_mismatches.launches
            verify.count_mismatches(runner.packing, outs, got, compare)
            verify.count_mismatches_plain(runner.packing, outs, want, compare)
            assert verify.count_mismatches.launches == before + 1
            assert got.tolist() == want.tolist()
            assert got[0].item() == (n_bad if compare else 0)
