"""The comparison that decides ``correct``.

The codec is lossless, so the answer to a request is known before it is
made: every image of the study, pixel for pixel, as the benchmark
generated it.  Two numbers are compared, each with the limit 0:

- ``pixels_wrong``: over the requests kept from the timed path (a seeded
  sample, and the last request of each study), the pixels of every image
  that differ from the generated slice; an image that is missing, of the
  wrong size, or beyond the study's count counts all its pixels;
- ``blob_pixels_wrong``: the pixels of every container of the pool that
  the request path's plain reference decoder (its ``reference_decode``,
  independent of the program) decodes to anything else than the
  generated slice; a container it cannot decode counts all its pixels.
  So the containers the program staged hold the images by themselves.

``studies_unchecked`` (limit 0) counts the staged studies of which no
request was kept, so that every study is judged.

The control is the reference put in the program's place with the
configuration's guarantee broken: each pixel's lowest bit cleared, a
15-bit decode of 16-bit data.

The lossless formats differ by request path, so the decoder is the
path's; nothing here knows a format.
"""

from __future__ import annotations

import struct
import sys

import numpy as np

LIMITS = {"pixels_wrong": 0, "blob_pixels_wrong": 0, "studies_unchecked": 0}
CHUNK = 256  # images compared in one device operation


class Sample:
    """The requests whose answers are kept for the comparison: a reservoir
    of ``size`` requests drawn by ``rng`` uniformly over the whole window,
    and each study's last request."""

    def __init__(self, rng: np.random.Generator, size: int):
        self.rng, self.size = rng, size
        self.seen = 0
        self.reservoir: list = []
        self.last: dict = {}

    def offer(self, study: int, images) -> None:
        self.last[study] = images
        if len(self.reservoir) < self.size:
            self.reservoir.append((study, images))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.reservoir[j] = (study, images)
        self.seen += 1

    def kept(self) -> list:
        """(study, images) of every kept request, each answer once."""
        out, ids = [], set()
        for study, images in [*self.reservoir, *self.last.items()]:
            if id(images) not in ids:
                ids.add(id(images))
                out.append((study, images))
        return out


def request_wrong(images, expected_idx, pool_dev, width: int, height: int) -> int:
    """Pixels of one answer (the program's list of (pixels, width,
    height)) that differ from the study's slices (``expected_idx``, pool
    indices; ``pool_dev``, the generated slices as int16 [P, h * w] on the
    answer's device)."""
    import torch

    npx = width * height
    n = len(expected_idx)
    wrong = npx * abs(len(images) - n)  # missing or extra images
    good = []
    for j, item in enumerate(images[:n]):
        px, w, h = item
        if ((w, h) != (width, height) or px.numel() != npx or px.element_size() != 2
                or px.device != pool_dev.device):
            wrong += npx
        else:
            good.append(j)
    idx = torch.as_tensor(np.asarray(expected_idx), device=pool_dev.device)
    for a in range(0, len(good), CHUNK):
        part = good[a:a + CHUNK]
        got = torch.stack([images[j][0].reshape(-1).view(torch.int16) for j in part])
        exp = pool_dev.index_select(0, idx[torch.as_tensor(part, device=idx.device)])
        wrong += int((got != exp).sum())
    return wrong


def compare_requests(kept, studies, pool_dev, width: int, height: int):
    """(pixels wrong over the kept answers, answers with a wrong pixel,
    studies of which no answer was kept)."""
    total = failed = 0
    for study, images in kept:
        w = request_wrong(images, studies[study], pool_dev, width, height)
        total += w
        failed += w > 0
    unchecked = len(set(range(len(studies))) - {s for s, _i in kept})
    return total, failed, unchecked


def blob_pixels_wrong(blobs, pool: np.ndarray, width: int, height: int, decode) -> int:
    """Pixels that the plain reference ``decode`` (blob -> (u16 [h * w], w,
    h)) decodes wrong over the pool's containers (a container it cannot
    decode: all its pixels)."""
    wrong = 0
    for blob, px in zip(blobs, pool):
        try:
            got, w, h = decode(blob)
        except (ValueError, IndexError, KeyError, struct.error) as e:
            print(f"check: a container the reference cannot decode: {e}", file=sys.stderr)
            wrong += px.size
            continue
        wrong += px.size if (w, h) != (width, height) else int(np.count_nonzero(got != px))
    return wrong


def control_answers(blobs, studies, device, decode):
    """The control: the plain reference ``decode`` in the program's place,
    each pixel's lowest bit cleared; one answer a study, as the program's
    (pixels, width, height) lists."""
    import torch

    decoded = []
    for blob in blobs:
        px, w, h = decode(blob)
        decoded.append((torch.from_numpy((px & 0xFFFE).view(np.int16)).to(device), w, h))
    return [(k, [decoded[int(j)] for j in idx]) for k, idx in enumerate(studies)]


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
