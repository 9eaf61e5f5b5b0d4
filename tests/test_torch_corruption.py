"""Corrupted containers through the port's decode.

On CUDA an out-of-bounds read faults, so the kernels keep the Pallas
kernels' margins and clamps.  The plain versions take the same guards
with bounds-checked gathers, so a corrupted stream that decodes on the
CPU without an index error reads nothing out of bounds on the card
either; the ``cuda`` test checks kernel == plain on the same streams.
A corrupted stream may decode to garbage (the format has no checksum)
or raise ValueError / NotImplementedError at parse or table build.  The
post stage clamps every gather (the kernel of ``csrc/post.cu`` as its
plain twin ``post.post_batch`` does), and the ``cuda`` test holds the
whole plan on the card, one post-kernel launch a plan with post buckets,
against the same plan on the CPU.  The MWR3 and
W3D1 containers add their own headers: truncated or damaged ones raise
ValueError, and a damaged plane stream decodes to garbage of the right
shape or raises, as above.  The PICS plan (``ref_decode.PicsDecodePlan``:
the tANS kernel, then the post kernel's interleaved-RLE route) takes
PICS-8 strips with damaged words, states, counts and headers: on the CPU
they stay in bounds, and the ``cuda`` test holds the plan on the card,
one tANS launch and one post launch, against the same plan on the CPU.
Needs no jax.
"""

import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from mic_tpu_torch import (
    MicwDecodePlan,
    micw_parse,
    micwr_decode_many,
    w3d_compress,
    w3d_decompress_level,
    w3d_decompress_region,
)
from mic_tpu_torch.parallel import strips as ps
from mic_tpu_torch.tpu import device_rans as dr
from mic_tpu_torch.tpu import post
from mic_tpu_torch.tpu import rans_decode as rd
from mic_tpu_torch.tpu import tans_decode as td
from mic_tpu_torch.tpu.ref_decode import PicsDecodePlan

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


CPU = torch.device("cpu")


@pytest.mark.parametrize("cut", [0, 3, 4, 12, 23])
def test_truncated_mwr3_header_raises(cut):
    blob = (TESTDATA / "tissue_dev.mwr3").read_bytes()
    with pytest.raises(ValueError):
        micwr_decode_many([blob[:cut]], CPU)


@pytest.mark.parametrize("kind", ["magic", "plane_cut", "plane_len_up", "plane_magic",
                                  "width_up", "height_up"])
def test_damaged_mwr3_raises_or_keeps_its_shape(kind):
    blob = bytearray((TESTDATA / "tissue_dev.mwr3").read_bytes())
    if kind == "magic":
        blob[:4] = b"MWR2"
    elif kind == "plane_cut":  # the last plane loses its tail
        blob = blob[: len(blob) - 4000]
    elif kind == "plane_len_up":  # the first plane claims the second one's bytes too
        struct.pack_into("<I", blob, 12, struct.unpack_from("<I", blob, 12)[0] + 999)
    elif kind == "plane_magic":
        blob[24:28] = b"MICX"
    elif kind == "width_up":  # wider than its planes
        struct.pack_into("<I", blob, 4, 640)
    else:  # taller than its planes
        struct.pack_into("<I", blob, 8, 385)
    try:
        (rgb, w, h), = micwr_decode_many([bytes(blob)], CPU)
    except ValueError:
        return
    assert kind == "plane_len_up"  # trailing bytes after a plane's last strip are not read
    assert (w, h) == (512, 384) and rgb.dtype == np.uint8 and rgb.size == w * h * 3


def _w3d():
    rgb = np.fromfile(TESTDATA / "tissue_dev.raw", np.uint8).reshape(384, 512, 3)
    tile = np.ascontiguousarray(rgb[64:320, 128:384])
    return w3d_compress(tile.reshape(-1), 256, 256, CPU, tile_w=128, tile_h=128,
                        num_levels=1, device_encode=True)


@pytest.mark.parametrize("cut", [0, 4, 27, 28, 60, 123])
def test_truncated_w3d_header_raises(cut):
    blob = _w3d()
    assert len(blob) > 28 + 4 * 24
    with pytest.raises(ValueError):
        w3d_decompress_level(blob[:cut], CPU)
    with pytest.raises(ValueError):
        w3d_decompress_region(blob[:cut], 0, 0, 10, 10, CPU)


@pytest.mark.parametrize("kind", ["magic", "payload_cut", "tile_off_up"])
def test_damaged_w3d_raises(kind):
    blob = bytearray(_w3d())
    if kind == "magic":
        blob[:4] = b"W3D2"
    elif kind == "payload_cut":  # the last tile's MWR3 blob loses its planes
        blob = blob[: 28 + 4 * 24 + struct.unpack_from("<I", blob, 28 + 3 * 24 + 16)[0] + 10]
    else:  # the first tile's payload starts past the end
        struct.pack_into("<I", blob, 28 + 16, len(blob))
    with pytest.raises(ValueError):
        w3d_decompress_level(bytes(blob), CPU)


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
    checked = posted = 0
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
        # The post kernel: the same garbage on the card as its plain twin on
        # the CPU, through one launch of csrc/post.cu (post_batch not called).
        launches, calls = post.post_decode_groups.launches, post.post_batch.calls
        got = plan.run()
        torch.cuda.synchronize()
        assert post.post_decode_groups.launches - launches == (1 if plan._post_keys else 0)
        assert post.post_batch.calls == calls
        posted += bool(plan._post_keys)
        want = MicwDecodePlan([blob], torch.device("cpu")).run()
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (name, kind, k)
    assert checked and posted


# ---------------------------------------------------------------------------
# PICS: the tANS kernel, then the post kernel's interleaved route
# ---------------------------------------------------------------------------

PICS_KINDS = ["words", "states", "count_up", "count_down", "ncount", "cut", "init_word"]


def _pics_corrupt(kind: str) -> bytes:
    """A seeded 72 x 40 image as a PICS-8 container of three strips, its
    first strip's stream damaged: bitstream words, the initial states (the
    stream's top bytes), the symbol count up or down, the normalized-count
    header, the strip cut short, or bytes flipped just past the header
    (where the Init word's and the first runs' bits lie)."""
    rng = np.random.default_rng(31 + PICS_KINDS.index(kind))
    img = (rng.standard_normal((40, 72)).cumsum(0).cumsum(1) * 5).astype(np.int64)
    px = (img - img.min()).clip(0, 60000).astype(np.uint16).ravel()
    blob = bytearray(ps.compress_parallel_strips_8state(px, 72, 40, int(px.max()), num_strips=3))
    off, length = struct.unpack_from("<II", blob, 20)
    at = 20 + 8 * 3 + off  # the first strip's FF 84 magic
    count = struct.unpack_from("<I", blob, at + 2)[0]
    end = at + length
    if kind == "words":
        for o in rng.integers(at + 40, end - 8, 24):
            blob[o] ^= 0xFF
    elif kind == "states":
        for o in range(end - 8, end - 1):
            blob[o] ^= 0x5A
    elif kind in ("count_up", "count_down"):
        struct.pack_into("<I", blob, at + 2, count * 2 if kind == "count_up" else count // 2)
    elif kind == "ncount":
        blob[at + 7] ^= 0x3C
    elif kind == "cut":
        struct.pack_into("<I", blob, 24, length // 2)
    else:
        for o in range(end - 24, end - 8):
            blob[o] ^= 0xA5
    return bytes(blob)


@pytest.mark.parametrize("kind", PICS_KINDS)
def test_corrupt_pics_stays_in_bounds(kind):
    blob = _pics_corrupt(kind)
    try:
        plan = PicsDecodePlan([blob], CPU)
    except (ValueError, NotImplementedError):
        return  # rejected at parse or table build
    (px, w, h), = plan.assemble_device(plan.run())
    assert (w, h) == (72, 40) and px.dtype == torch.int16 and px.numel() == w * h


@pytest.mark.cuda
def test_cuda_corrupt_pics_match_plain():
    """Each damaged container's plan on the card: one tANS launch and one
    post launch, no twin called, and the same outputs as the plan on the
    CPU (the tANS twin, then ``post_batch``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    checked = 0
    for kind in PICS_KINDS:
        blob = _pics_corrupt(kind)
        try:
            plan = PicsDecodePlan([blob], torch.device("cuda"))
        except (ValueError, NotImplementedError):
            continue
        tans, posts = td.tans_decode_groups.launches, post.post_decode_groups.launches
        calls = post.post_batch.calls
        got = plan.run()
        torch.cuda.synchronize()
        assert td.tans_decode_groups.launches - tans == 1
        assert post.post_decode_groups.launches - posts == 1 and post.post_batch.calls == calls
        want = PicsDecodePlan([blob], CPU).run()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (kind, k)
        checked += 1
    assert checked
