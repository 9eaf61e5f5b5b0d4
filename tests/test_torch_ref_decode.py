"""The port's reference-format device decode (``mic_tpu_torch.tpu.ref_decode``)
against mic_tpu and the in-repo fixtures.

* the container parsers the port copied (MIC1, PICS, MIC2, MIC3) against
  ``mic_tpu``'s, field for field;
* every entry point against ``mic_tpu.tpu.ref_decode``'s (whose tANS
  kernel runs in interpret mode) on seeded images: frames under avg, grad
  and residual at 2, 4 and 8 states, PICS containers one at a time and
  many at once, MIC2 series independent and temporal, MIC3 tiles,
  regions and levels (RGB with YCoCg-R, grey 16-bit), and an unsupported
  kind raising;
* ``PicsDecodePlan`` (the PICS plan that keeps its answer on the
  device) on CT and MR fixture crops at 2, 4 and 8 states, with a last
  strip shorter than the others and widths that are not multiples of
  128, against ``mic_tpu``'s ``decompress_pics_device_many`` (8 states;
  its host reader at 2 and 4), the benchmark's plain reference
  (``portbench/reference_pics.py``) and the port's entropy batch with the
  host post stage; its kinds and routes;
* the in-repo fixtures against their ``.raw`` pixels through the port
  alone: the MR MIC1 payloads (FF 02/04/84/08), the four PICS containers
  (``CT_pics4`` takes both routes: strip 0 the kernel, strips 1-3 the
  host), ``grey.mic3`` and ``tissue.mic3``, and the two MIC2 series below.

``tests/data/torch_port/MR_series_ind.mic2`` and ``MR_series_tmp.mic2``
are three-frame 256x256 series made from ``web/testdata/MR_2s.raw`` by
``mic_tpu.parallel.multiframe.compress_multi_frame`` (the frames of
:func:`_series_frames`); every frame is a 2-state stream at tableLog 13
with fewer than 4096 symbols, so the kernel decodes it (no other in-repo
MIC2 reaches the kernel).  ``test_series_fixtures_are_reproducible``
rebuilds them.

Tolerance 0.  On the CPU every kernel wrapper runs its plain version.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mic_tpu_torch.parallel import multiframe, strips, wsi
from mic_tpu_torch.tpu import ref_decode as rd
from mic_tpu_torch.tpu.tans_decode import TansDecodePlan
from mic_tpu_torch.utils.io import read_mic1

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "web" / "testdata"
PORT_DATA = ROOT / "tests" / "data" / "torch_port"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref():
    """mic_tpu's reference-format coders and device decode (needs jax)."""
    pytest.importorskip("jax")
    from mic_tpu.models import single_frame
    from mic_tpu.parallel import multiframe as rmf
    from mic_tpu.parallel import strips as rstrips
    from mic_tpu.parallel import wsi as rwsi
    from mic_tpu.tpu import ref_decode as rrd
    from mic_tpu.utils import io as rio

    return SimpleNamespace(sf=single_frame, mf=rmf, strips=rstrips, wsi=rwsi, rd=rrd, io=rio)


@pytest.fixture
def rng():
    return np.random.default_rng(77)


def _image(rng, h, w, scale=5):
    img = (rng.standard_normal((h, w)).cumsum(0).cumsum(1) * scale).astype(np.int64)
    return (img - img.min()).clip(0, 60000).astype(np.uint16).ravel()


def _raw(name):
    return np.fromfile(TESTDATA / f"{name}.raw", dtype="<u2")


def _series_frames():
    mr = _raw("MR_2s").reshape(256, 256)
    return {"ind": ([mr, mr[::-1], np.roll(mr, 3, axis=1)], False),
            "tmp": ([np.roll(mr, k, axis=0) for k in range(3)], True)}


# ---------------------------------------------------------------------------
# Container parsers
# ---------------------------------------------------------------------------


def test_container_parsers_match(ref):
    for name in ("MR_2s", "CT_8s"):
        data = (TESTDATA / f"{name}.mic").read_bytes()
        assert read_mic1(data) == ref.io.read_mic1(data)
    for name in ("MR_pics4", "CT_pics8"):
        data = (TESTDATA / f"{name}.pics").read_bytes()
        assert strips.pics_strip_blobs(data) == ref.strips.pics_strip_blobs(data)
    for name in ("series_ind", "series_dev_tmp"):
        data = (TESTDATA / f"{name}.mic2").read_bytes()
        (h, e, o), (rh, re_, ro) = (multiframe.read_mic2_header(data),
                                    ref.mf.read_mic2_header(data))
        assert vars(h) == vars(rh) and (e, o) == (re_, ro)
        assert multiframe.extract_frame(data, e, o, 1) == ref.mf.extract_frame(data, e, o, 1)
    for name in ("grey", "tissue"):
        data = (TESTDATA / f"{name}.mic3").read_bytes()
        (h, e, o), (rh, re_, ro) = wsi.read_mic3_header(data), ref.wsi.read_mic3_header(data)
        assert (h.width, h.height, h.tile_width, h.tile_height, h.channels,
                h.bits_per_sample, h.color_transform) == (
            rh.width, rh.height, rh.tile_width, rh.tile_height, rh.channels,
            rh.bits_per_sample, rh.color_transform)
        assert [vars(lv) for lv in h.levels] == [vars(lv) for lv in rh.levels]
        assert (e, o) == (re_, ro)
        assert wsi.extract_tile_blob(data, e, o, 0) == ref.wsi.extract_tile_blob(data, e, o, 0)
    for bad in (b"", b"MIC1" + bytes(30), b"XXXX" + bytes(60)):
        for port_fn, ref_fn in ((read_mic1, ref.io.read_mic1),
                                (strips.pics_strip_blobs, ref.strips.pics_strip_blobs),
                                (multiframe.read_mic2_header, ref.mf.read_mic2_header),
                                (wsi.read_mic3_header, ref.wsi.read_mic3_header)):
            try:
                want = ref_fn(bad)
            except ValueError:
                with pytest.raises(ValueError):
                    port_fn(bad)
                continue
            assert port_fn(bad) is not None and want is not None
    px = np.arange(300, dtype=np.uint16)
    for bps in (8, 16):
        assert wsi._u16_to_bytes(px, bps) == ref.wsi._u16_to_bytes(px, bps)
        assert wsi._bytes_per_pixel(3, bps) == ref.wsi._bytes_per_pixel(3, bps)


def test_series_fixtures_are_reproducible(ref):
    for name, (frames, temporal) in _series_frames().items():
        frames = [np.ascontiguousarray(f).ravel() for f in frames]
        blob = ref.mf.compress_multi_frame(frames, 256, 256, int(max(f.max() for f in frames)),
                                           temporal=temporal)
        assert blob == (PORT_DATA / f"MR_series_{name}.mic2").read_bytes()
        hdr, entries, off = multiframe.read_mic2_header(blob)
        plan = TansDecodePlan([multiframe.extract_frame(blob, entries, off, i)
                               for i in range(hdr.frame_count)], CPU)
        assert plan.stats["host"] == [] and plan.stats["kernel"] == 3


# ---------------------------------------------------------------------------
# Entry points against mic_tpu's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comp,kind", [("compress_single_frame", "avg"),
                                       ("compress_single_frame_4state", "avg"),
                                       ("compress_single_frame_8state", "avg"),
                                       ("compress_single_frame_rans8", "avg"),
                                       ("compress_single_frame_grad", "grad")])
def test_frames_match_reference(ref, rng, comp, kind):
    geo = [(64, 48), (96, 32)]
    imgs = [_image(rng, h, w) for w, h in geo]
    blobs = [getattr(ref.sf, comp)(p, w, h, int(p.max())) for p, (w, h) in zip(imgs, geo)]
    got = rd.decompress_frames_device(blobs, geo, CPU, kind=kind)
    want = ref.rd.decompress_frames_device(blobs, geo, kind=kind)
    for g, w_, p in zip(got, want, imgs):
        assert g.dtype == np.uint16 and np.array_equal(g, w_) and np.array_equal(g, p)


def test_residual_kind_and_unsupported_kind(ref, rng):
    res = rng.integers(0, 9, 3000).astype(np.uint16)
    blob = ref.sf.compress_residual_frame(res, int(res.max()))
    (got,) = rd.decompress_frames_device([blob], [(0, 0)], CPU, kind="residual")
    (want,) = ref.rd.decompress_frames_device([blob], [(0, 0)], kind="residual")
    assert np.array_equal(got, want) and np.array_equal(got, res)
    px = _image(rng, 32, 32)
    blob = ref.sf.compress_single_frame(px, 32, 32, int(px.max()))
    with pytest.raises(ValueError):
        rd.decompress_frames_device([blob], [(32, 32)], CPU, kind="nope")


def test_pics_match_reference(ref, rng):
    imgs = [_image(rng, 64, 64), _image(rng, 96, 64), _image(rng, 64, 128)]
    geo = [(64, 64), (64, 96), (128, 64)]
    blobs = [ref.strips.compress_parallel_strips_4state(p, w, h, int(p.max()), num_strips=3)
             for p, (w, h) in zip(imgs, geo)]
    blobs.append(ref.strips.compress_parallel_strips_8state(imgs[0], 64, 64, int(imgs[0].max()),
                                                            num_strips=2))
    got = rd.decompress_pics_device_many(blobs, CPU)
    want = ref.rd.decompress_pics_device_many(blobs)
    for (g, gw, gh), (w_, ww, wh), p in zip(got, want, imgs + imgs[:1]):
        assert (gw, gh) == (ww, wh) and np.array_equal(g, w_) and np.array_equal(g, p)
    px, w, h = rd.decompress_pics_device(blobs[1], CPU)
    assert (w, h) == (64, 96) and np.array_equal(px, imgs[1])


@pytest.mark.parametrize("temporal", [False, True])
def test_mic2_match_reference(ref, rng, temporal):
    base = _image(rng, 40, 56)
    frames = [base]
    for _ in range(3):
        nxt = frames[-1].astype(np.int64) + rng.integers(-3, 4, size=base.size)
        frames.append(nxt.clip(0, 60000).astype(np.uint16))
    blob = ref.mf.compress_multi_frame(frames, 56, 40, int(max(f.max() for f in frames)),
                                       temporal=temporal)
    got, hdr = rd.decompress_mic2_device(blob, CPU)
    want, _ = ref.rd.decompress_mic2_device(blob)
    assert hdr.temporal == temporal and hdr.frame_count == 4
    for g, w_, f in zip(got, want, frames):
        assert np.array_equal(g, w_) and np.array_equal(g, f)
    px, _ = rd.decompress_mic2_frame_device(blob, 2, CPU)
    assert np.array_equal(px, ref.rd.decompress_mic2_frame_device(blob, 2)[0])
    assert np.array_equal(px, frames[2])
    with pytest.raises(ValueError):
        rd.decompress_mic2_frame_device(blob, 4, CPU)


def test_wsi_match_reference(ref, rng):
    """RGB (YCoCg-R): the cropped corner tile, a cross-tile region, the
    top level, and level 0 against the pixels; a grey 16-bit region."""
    img = (rng.standard_normal((100, 150, 3)).cumsum(0).cumsum(1) * 3 + 128)
    rgb = img.clip(0, 255).astype(np.uint8).ravel()
    opts = ref.wsi.WSIOptions(tile_width=64, tile_height=64)
    blob = ref.wsi.compress_wsi(rgb, 150, 100, 3, 8, opts)
    hdr = wsi.read_mic3_header(blob)[0]
    got = rd.decompress_wsi_tile_device(blob, 0, 2, 1, CPU)  # the cropped corner tile
    assert got == ref.rd.decompress_wsi_tile_device(blob, 0, 2, 1)
    got = rd.decompress_wsi_region_device(blob, 0, 50, 30, 80, 60, CPU)
    assert got == ref.rd.decompress_wsi_region_device(blob, 0, 50, 30, 80, 60)
    lvl = len(hdr.levels) - 1
    assert rd.decompress_wsi_level_device(blob, lvl, CPU) == \
        ref.rd.decompress_wsi_level_device(blob, lvl)
    assert rd.decompress_wsi_level_device(blob, 0, CPU) == rgb.tobytes()

    grey = _image(rng, 80, 110)
    gblob = ref.wsi.compress_wsi(np.asarray(grey, "<u2").tobytes(), 110, 80, 1, 16,
                                 ref.wsi.WSIOptions(tile_width=64, tile_height=64))
    got = rd.decompress_wsi_region_device(gblob, 0, 32, 16, 60, 50, CPU)
    assert got == ref.rd.decompress_wsi_region_device(gblob, 0, 32, 16, 60, 50)
    for bad in (lambda: rd.decompress_wsi_tile_device(blob, 99, 0, 0, CPU),
                lambda: rd.decompress_wsi_tile_device(blob, 0, 9, 0, CPU),
                lambda: rd.decompress_wsi_region_device(blob, 0, 149, 99, 0, 0, CPU),
                lambda: rd.decompress_wsi_level_device(blob, -1, CPU)):
        with pytest.raises(ValueError):
            bad()


# ---------------------------------------------------------------------------
# In-repo fixtures against their pixels, through the port alone
# ---------------------------------------------------------------------------


def test_mic1_fixtures_decode():
    names = ["MR_8s", "MR_rans8", "MR_4s"]
    payloads = [read_mic1((TESTDATA / f"{n}.mic").read_bytes()) for n in names]
    stats = {}
    from mic_tpu_torch.tpu.tans_decode import fse_decompress_device_batch

    syms = fse_decompress_device_batch([p[3] for p in payloads], CPU, stats=stats)
    assert stats["host"] == [] and stats["groups"] == 3
    outs = [rd._invert(s, w, h, "avg") for s, (w, h, _pl, _b) in zip(syms, payloads)]
    for out, n in zip(outs, names):
        assert np.array_equal(out, _raw(n))


def test_pics_fixtures_decode():
    """The four PICS fixtures in one batch: CT_pics4's strips 1-3 (tableLog
    14) take the host route, every other strip the kernel."""
    names = ["MR_pics4", "MR_pics8", "CT_pics4", "CT_pics8"]
    blobs = [(TESTDATA / f"{n}.pics").read_bytes() for n in names]
    flat = [s[2] for b in blobs for s in strips.pics_strip_blobs(b)[3]]
    plan = TansDecodePlan(flat, CPU)
    assert plan.stats["host"] == [13, 14, 15] and plan.stats["kernel"] == len(flat) - 3
    for (px, w, h), n in zip(rd.decompress_pics_device_many(blobs, CPU), names):
        assert np.array_equal(px, _raw(n)) and w * h == px.size


@pytest.mark.parametrize("name", ["ind", "tmp"])
def test_mic2_fixtures_decode(name):
    frames, temporal = _series_frames()[name]
    blob = (PORT_DATA / f"MR_series_{name}.mic2").read_bytes()
    got, hdr = rd.decompress_mic2_device(blob, CPU)
    assert hdr.temporal == temporal and (hdr.width, hdr.height) == (256, 256)
    for g, f in zip(got, frames):
        assert np.array_equal(g, f.ravel())


def test_mic3_fixtures_decode():
    grey = (TESTDATA / "grey.mic3").read_bytes()
    assert rd.decompress_wsi_level_device(grey, 0, CPU) == _raw("grey").tobytes()
    tissue = (TESTDATA / "tissue.mic3").read_bytes()
    want = np.fromfile(TESTDATA / "tissue.raw", np.uint8)
    assert rd.decompress_wsi_level_device(tissue, 0, CPU) == want.tobytes()


# ---------------------------------------------------------------------------
# PicsDecodePlan: the answer on the device
# ---------------------------------------------------------------------------


def _crops():
    """Crops of the CT and MR fixtures (200 x 70 and 90 x 50, the top left
    corners: widths not multiples of 128; smaller or noisier CT crops are
    incompressible at these sizes) and a smooth seeded image (72 x 40)."""
    ct = _raw("CT_dev").reshape(512, 512)[:70, :200]
    mr = _raw("MR_2s").reshape(256, 256)[:50, :90]
    smooth = _image(np.random.default_rng(9), 40, 72)
    return [(np.ascontiguousarray(ct).ravel(), 200, 70), (np.ascontiguousarray(mr).ravel(), 90, 50),
            (smooth, 72, 40)]


@pytest.mark.parametrize("states", [2, 4, 8])
def test_pics_plan_matches_reference_and_plain(ref, states):
    """Three strips a crop, so each crop's last strip is shorter; the
    plan's device answer equals the pixels, ``mic_tpu``'s decode (its
    device decode at 8 states, the benchmark cell's format; its host
    reader at 2 and 4, where the device decode's interpret-mode compile
    would take most of a minute), the plain reference and the entropy
    batch with the host post stage."""
    from portbench.reference_pics import decode_pics

    writer = getattr(ref.strips, {2: "compress_parallel_strips",
                                  4: "compress_parallel_strips_4state",
                                  8: "compress_parallel_strips_8state"}[states])
    crops = _crops()
    blobs = [writer(px, w, h, int(px.max()), num_strips=3) for px, w, h in crops]
    plan = rd.PicsDecodePlan(blobs, CPU)
    assert plan.host == [] and plan.tans.stats["groups"] == 1
    assert len(plan._post_rows) == len({(w, -(-h // 3)) for _p, w, h in crops}
                                       | {(w, h - 2 * -(-h // 3)) for _p, w, h in crops})
    images = plan.assemble_device(plan.run())
    want = (ref.rd.decompress_pics_device_many(blobs) if states == 8
            else [ref.strips.decompress_parallel_strips(b) for b in blobs])
    host = rd._pics_many(blobs, CPU, "avg")[0]
    for (px, w, h), (got, gw, gh), (wpx, ww, wh), blob, hp in zip(crops, images, want, blobs, host):
        got = got.numpy().view(np.uint16)
        assert (gw, gh) == (w, h) == (ww, wh) and got.dtype == np.uint16
        assert np.array_equal(got, px) and np.array_equal(got, wpx) and np.array_equal(got, hp)
        assert np.array_equal(decode_pics(blob)[0], px)


def _pics_with_a_one_state_strip():
    """A seeded 72 x 40 image as a 2-state PICS container of three strips
    whose middle strip is a 1-state stream (the writers' last fallback),
    which the kernel does not take.  Returns (container, pixels)."""
    import struct

    from mic_tpu_torch.ops.deltarle import delta_rle_compress
    from mic_tpu_torch.ops.fse_codec import fse_compress

    px = _image(np.random.default_rng(12), 40, 72)
    w, h, sh, st = strips.pics_strip_blobs(
        strips.compress_parallel_strips(px, 72, 40, int(px.max()), num_strips=3))
    y0, rows, _b = st[1]
    parts = [st[0][2], fse_compress(delta_rle_compress(px[y0 * w:(y0 + rows) * w], w, rows,
                                                       int(px.max()))), st[2][2]]
    offsets = np.concatenate([[0], np.cumsum([len(b) for b in parts])])
    table = b"".join(struct.pack("<II", int(o), len(b)) for o, b in zip(offsets, parts))
    return b"PICS" + struct.pack("<IIII", w, h, 3, sh) + table + b"".join(parts), px


def test_pics_plan_kinds_and_host_route():
    """Only the avg kind takes the plan; an unknown kind raises; a stream
    the kernel cannot take (a 1-state strip) decodes on the host inside
    ``run()``, its pixels one copy to the device."""
    blob, px = _pics_with_a_one_state_strip()
    with pytest.raises(ValueError, match="avg kind"):
        rd.PicsDecodePlan([blob], CPU, kind="grad")
    with pytest.raises(ValueError):
        rd.decompress_pics_device(blob, CPU, kind="nope")
    plan = rd.PicsDecodePlan([blob, blob], CPU)
    assert plan.host == [1, 4] and [w is None for w in plan.where] == [False, True, False] * 2
    outs = plan.run()
    assert set(outs) == {0, 1, "host"} and outs["host"].numel() == 2 * 72 * 14
    for got, w, h in plan.assemble_device(outs):
        assert (w, h) == (72, 40) and np.array_equal(got.numpy().view(np.uint16), px)
    assert np.array_equal(rd.decompress_pics_device(blob, CPU)[0], px)
