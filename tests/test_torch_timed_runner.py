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

The ``cuda`` test runs the runner on the card; it needs no jax.
"""

import numpy as np
import pytest
import torch

from mic_tpu_torch import MicwDecodePlan
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


def _run(device, blobs, expected):
    plan = MicwDecodePlan(blobs, device)
    runner = plan.make_timed_runner(expected)
    mism, probe = runner(REPS)
    assert mism.device.type == probe.device.type == plan.device.type
    assert mism.dim() == probe.dim() == 0
    return plan, runner, int(mism), int(probe)


def test_runner_true_pixels(batch):
    assert _run(CPU, *batch)[2] == 0


@pytest.mark.parametrize("k", [1, 2, 4])
def test_runner_counts_flipped_pixels(batch, k):
    blobs, expected = batch
    bad = _flipped(expected, FLIPS[:k])
    plan, _runner, mism, _probe = _run(CPU, blobs, bad)
    assert mism == k == plan.verify_batch(plan.run(), bad)


def test_runner_probe_sums_first_values(batch):
    plan, _runner, _mism, probe = _run(CPU, *batch)
    first = sum(int((out[0, :8].to(torch.int64) & 0xFFFF).sum()) for out in plan.run().values())
    assert probe == REPS * first


def test_runner_tiles_a_replicated_blob(batch):
    """One blob x3 with one expected object: the expected rows are staged
    once and tiled, and a flip counts once a replica."""
    blobs, expected = batch
    bad = _flipped(expected[:1], [(0, 7)])[0]
    plan, _runner, mism, _probe = _run(CPU, blobs[:1] * REPS, [bad] * REPS)
    assert mism == REPS == plan.verify_batch(plan.run(), [bad] * REPS)


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
    for picks in ([], FLIPS[:3]):
        exp = _flipped(expected[:n], picks)
        want, _p = ref.make_timed_runner(exp)(REPS)
        assert _run(CPU, blobs[:n], exp)[2] == int(want) == len(picks)
    bad = _flipped(expected[:n], [(2 * REPS, 128 * 8 + 9)])
    assert ref.make_timed_runner(bad) is None
    assert MicwDecodePlan(blobs[:n], CPU).make_timed_runner(bad) is None
    assert RefPlan(blobs).make_timed_runner(expected) is None


@pytest.mark.cuda
def test_cuda_runner_counts_like_the_cpu(batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    blobs, expected = batch
    for picks in ([], FLIPS):
        exp = _flipped(expected, picks)
        plan, _runner, mism, probe = _run(torch.device("cuda"), blobs, exp)
        assert mism == len(picks) == plan.verify_batch(plan.run(), exp)
        assert probe == _run(CPU, blobs, exp)[3]
