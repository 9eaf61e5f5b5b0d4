"""Traffic generation: slices, studies and the order of requests, all
drawn from ``--seed``.

A configuration (``configs/<name>.json``) names one real slice and how to
vary it; a traffic mix (``traffic/<name>.json``) names how the slices are
written and decoded (its request path, ``paths/<name>.py``, writes them).
The configuration's ``pool_seed`` draws its pool of distinct slices
(shifted, flipped and offset copies of the real one, never transposed);
from a run's seed this module draws the studies (the configuration's
study sizes, each study every pool slice in turn, in a seeded order) and
an endless request order (rounds, each a seeded
permutation of the studies).  So every seed serves the same slices in
the same amounts, in another order: the seed changes the order of the
work, not the work.  It imports nothing of the program.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# independent streams drawn from one seed
_POOL, _STUDIES, _ORDER, _SAMPLE = range(4)


def streams(seed: int, n: int = 4) -> list[np.random.Generator]:
    """``n`` independent generators from a whole number of any sign and
    size."""
    base = np.random.SeedSequence([abs(int(seed)) & (2**64 - 1), abs(int(seed)) >> 64,
                                   int(seed < 0)])
    return [np.random.default_rng(s) for s in base.spawn(n)]


def source_slice(config: dict, root: Path = ROOT) -> np.ndarray:
    """The configuration's real slice, u16 [height, width]."""
    px = np.fromfile(root / config["slice_file"], dtype="<u2")
    return px.reshape(config["height"], config["width"])


def make_pool(config: dict, root: Path = ROOT) -> np.ndarray:
    """``pool_slices`` distinct slices, u16 [P, height * width], drawn from
    ``pool_seed``: the real slice rolled by up to ``shift_max`` rows and
    columns, flipped left-right and top-bottom each with probability 1/2,
    plus an offset from ``intensity_offset`` added modulo 2^16 (the
    slice's own arithmetic: two's-complement CT values move as signed
    ones)."""
    rng = streams(config["pool_seed"])[_POOL]
    src = source_slice(config, root).astype(np.int64)
    sy, sx = config["shift_max"]
    lo, hi = config["intensity_offset"]
    pool = np.empty((config["pool_slices"], src.size), np.uint16)
    for i in range(len(pool)):
        img = np.roll(src, (int(rng.integers(-sy, sy + 1)), int(rng.integers(-sx, sx + 1))),
                      axis=(0, 1))
        if rng.integers(2):
            img = img[:, ::-1]
        if rng.integers(2):
            img = img[::-1]
        pool[i] = ((img + int(rng.integers(lo, hi + 1))) & 0xFFFF).ravel()
    return pool


def make_studies(config: dict, seed: int) -> list[np.ndarray]:
    """The staged studies, each an int64 array of pool indices, one a
    slice: the configuration's ``study_slices`` in a seeded order, each
    study a run of seeded permutations of the pool cut to its size (so
    each slice appears in it as often as any other, give or take one).
    ``staged_studies`` must count the sizes."""
    if config["staged_studies"] != len(config["study_slices"]):
        raise ValueError(f"{config['name']}: staged_studies {config['staged_studies']} but "
                         f"{len(config['study_slices'])} study sizes")
    rng = streams(seed)[_STUDIES]
    sizes = rng.permutation(np.asarray(config["study_slices"], np.int64))
    p = config["pool_slices"]
    return [np.concatenate([rng.permutation(p) for _ in range(-(-int(n) // p))])[:int(n)]
            for n in sizes]


def request_order(n_studies: int, seed: int):
    """Study indices without end: rounds, each a seeded permutation of
    every study, so any window holds each study as often as the others to
    within one round."""
    rng = streams(seed)[_ORDER]
    while True:
        yield from (int(k) for k in rng.permutation(n_studies))


def sample_rng(seed: int) -> np.random.Generator:
    """The generator that picks the requests whose outputs are checked."""
    return streams(seed)[_SAMPLE]
