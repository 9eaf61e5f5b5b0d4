"""Traffic generation: deterministic for a seed, different across seeds,
the same amount of work for every seed."""

import itertools

import numpy as np

from portbench import harness, studies

CT = harness.load_config("ct_512_study")
MR = harness.load_config("mr_256_exam")


def test_pool_is_the_configurations():
    """The pool is drawn from the configuration's pool_seed: every run seed
    serves the same slices; another pool_seed draws other ones."""
    a = studies.make_pool(MR)
    assert np.array_equal(a, studies.make_pool(MR))
    assert not np.array_equal(a, studies.make_pool({**MR, "pool_seed": MR["pool_seed"] + 1}))
    assert a.shape == (MR["pool_slices"], MR["width"] * MR["height"]) and a.dtype == np.uint16
    assert len({row.tobytes() for row in a}) == len(a)  # distinct slices


def test_variants_keep_the_slice():
    """Shifts, flips and offsets only: each variant's sorted values are the
    source's plus one offset (modulo 2^16), and MR stays within 11 bits."""
    src = studies.source_slice(MR).astype(np.int64).ravel()
    pool = studies.make_pool(MR)
    assert int(pool.max()) <= 2047
    for row in pool:
        off = int(np.sort(row.astype(np.int64))[0] - np.sort(src)[0])
        assert np.array_equal(np.sort(row.astype(np.int64)), np.sort(src) + off)
    ct = studies.make_pool(CT)
    ct_src = np.sort(studies.source_slice(CT).astype(np.int64).ravel())
    for row in ct:
        signed = np.sort(row.astype(np.int16).astype(np.int64))
        off = int(signed[0] - np.sort(ct_src.astype(np.uint16).astype(np.int16))[0])
        assert -64 <= off <= 64


def test_studies_same_work_every_seed():
    """Every seed stages the same study sizes, each study every pool slice
    as often as any other give or take one, in another order."""
    for seed in (0, 1, 2**31 + 3, -9):
        s = studies.make_studies(CT, seed)
        assert sorted(len(x) for x in s) == sorted(CT["study_slices"])
        for x in s:
            counts = np.bincount(x, minlength=CT["pool_slices"])
            assert counts.max() - counts.min() <= 1
    s1, s2 = studies.make_studies(CT, 10), studies.make_studies(CT, 10)
    assert all(np.array_equal(a, b) for a, b in zip(s1, s2))
    s3 = studies.make_studies(CT, 11)
    assert not all(len(a) == len(b) and np.array_equal(a, b) for a, b in zip(s1, s3))


def test_request_order_is_balanced_rounds():
    order = list(itertools.islice(studies.request_order(4, 123), 40))
    assert order == list(itertools.islice(studies.request_order(4, 123), 40))
    assert order != list(itertools.islice(studies.request_order(4, 124), 40))
    for r in range(10):
        assert sorted(order[4 * r:4 * r + 4]) == [0, 1, 2, 3]
