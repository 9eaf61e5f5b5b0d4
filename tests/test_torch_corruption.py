"""Corrupted containers through the port's decode.

On CUDA an out-of-bounds read faults, so the kernels keep the Pallas
kernels' margins and clamps.  The plain versions take the same guards
with bounds-checked gathers, so a corrupted stream that decodes on the
CPU without an index error reads nothing out of bounds on the card
either; the ``cuda`` test checks kernel == plain on the same streams.
A corrupted stream may decode to garbage (the format has no checksum)
or raise ValueError / NotImplementedError at parse or table build.  The
post path's torch ops clamp every gather, and the ``cuda`` test holds the
whole plan on the card against the same plan on the CPU.  Needs no jax.
"""

import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from mic_tpu_torch import MicwDecodePlan, micw_parse
from mic_tpu_torch.tpu import device_rans as dr
from mic_tpu_torch.tpu import rans_decode as rd

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "web" / "testdata"
PORT_DATA = ROOT / "tests" / "data" / "torch_port"
# Direct-mode fixtures, r-mode ones (every strip zzr / vdr / pdr) that run
# the fused r-kernels (FF 57, and FF 41 with escapes), and post-path ones:
# avg strips through the packed symbols kernel, CT at tl 13 through the
# two-table kernel.
FIXTURES = {n: d / n for d, names in ((TESTDATA, ("MR_dev.micw", "MR_dev_alias.micw",
                                                  "MR_dev_auto.micw")),
                                      (PORT_DATA, ("tissue_g_rstd.micw",
                                                   "tissue_g_zzr_alias.micw",
                                                   "CT_dev_tl13.micw")))
            for n in names}
KINDS = ["words", "states", "count_up", "count_down", "n_words_down", "escapes", "ncount"]


def _corrupt(name: str, kind: str) -> bytes:
    """``name``'s container with its first strip's MICT stream damaged."""
    blob = bytearray(FIXTURES[name].read_bytes())
    mict = micw_parse(bytes(blob))[7][0][0]
    at = bytes(blob).find(mict)
    L, _tl, count, _states, words, _norm, _sl, alias = dr.mict_parse(mict)
    n_esc = len(alias[1]) if alias is not None else 0
    words_at = at + len(mict) - 2 * (len(words) + n_esc)
    rng = np.random.default_rng(KINDS.index(kind))
    if kind == "words":
        for o in rng.integers(words_at, words_at + 2 * len(words), 64):
            blob[o] ^= 0xFF
    elif kind == "states":
        for o in rng.integers(words_at - 4 * L, words_at, 32):
            blob[o] ^= 0x5A
    elif kind in ("count_up", "count_down"):
        struct.pack_into("<I", blob, at + 4, count * 2 if kind == "count_up" else count // 2)
    elif kind == "n_words_down":
        struct.pack_into("<I", blob, at + 8, len(words) // 2)
    elif kind == "escapes":
        for o in rng.integers(words_at + 2 * len(words), at + len(mict), 64):
            blob[o] ^= 0xFF
    else:  # normalized-count header
        hdr = at + (18 if alias is not None else 12)
        blob[hdr + 1] ^= 0x3C
    return bytes(blob)


CASES = [(name, kind) for name in FIXTURES for kind in KINDS
         if kind != "escapes" or "alias" in name]  # FF 57 has no escape stream


@pytest.mark.parametrize("name,kind", CASES)
def test_corrupt_stream_stays_in_bounds(name, kind):
    blob = _corrupt(name, kind)
    try:
        plan = MicwDecodePlan([blob], torch.device("cpu"))
    except (ValueError, NotImplementedError):
        return  # rejected at parse or table build
    (out, w, h), = plan.assemble(plan.run())
    assert (w, h) == micw_parse(blob)[:2] and out.dtype == np.uint16 and out.size == w * h


@pytest.mark.cuda
def test_cuda_corrupt_streams_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plain = {rd.rans_decode_zzd: rd.rans_decode_zzd_plain,
             rd.rans_decode_alias: rd.rans_decode_alias_plain,
             rd.rans_decode_rle: rd.rans_decode_rle_plain,
             rd.rans_decode_rle_alias: rd.rans_decode_rle_alias_plain,
             rd.rans_decode_packed: rd.rans_decode_packed_plain,
             rd.rans_decode: rd.rans_decode_plain}
    checked = 0
    for name, kind in CASES:
        blob = _corrupt(name, kind)
        try:
            plan = MicwDecodePlan([blob], torch.device("cuda"))
        except (ValueError, NotImplementedError):
            continue
        for b in plan.buckets.values():
            got = b.fn(*b.ops, **b.kwargs)
            torch.cuda.synchronize()
            assert torch.equal(got, plain[b.fn](*b.ops, **b.kwargs)), (name, kind)
            checked += 1
        # The post path's torch ops: the same garbage on the card as on the CPU.
        got, want = plan.run(), MicwDecodePlan([blob], torch.device("cpu")).run()
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (name, kind, k)
    assert checked
