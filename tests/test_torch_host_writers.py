"""The port's host writers and readers of the reference formats against
``mic_tpu``'s, and the port's writers read back by its device readers.

* every writer of ``mic_tpu_torch.ops`` / ``.models`` / ``.parallel`` /
  ``.utils.io`` against its ``mic_tpu`` original on seeded images (37x23,
  64x64, 96x80, and the corner cases: a constant image, a one-row strip,
  a two-pixel frame), byte for byte, or the same exception;
* each of the 19 reference fixtures of ``web/testdata`` (MIC1, PICS,
  PICA, MIC2, MICR, MIC3), rewritten from its ``.raw`` as
  ``web/gen_testdata.py`` writes it (through ``chip_smoke.py``'s phase
  12 (a) code), equal to the file;
* each host reader (MIC1, PICS, PICA, MICR, MIC2 whole and one frame,
  MIC3 tile and region) against ``mic_tpu``'s, array for array;
* the port's writers' output decoded by the port's device readers on
  ``torch.device("cpu")`` (the kernels' plain twins), equal to the input.

Tolerance 0: these are the bytes of the formats.
"""

from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

import mic_tpu_torch as port
from chip_smoke import REF_FIXTURES, _fixture_container
from mic_tpu.models import rgb as ref_rgb
from mic_tpu.models import single_frame as ref_sf
from mic_tpu.ops import deltarle as ref_deltarle
from mic_tpu.ops import fse_codec as ref_fse_codec
from mic_tpu.ops import predictors as ref_pred
from mic_tpu.ops import pyramid as ref_pyramid
from mic_tpu.ops import rle as ref_rle
from mic_tpu.parallel import multiframe as ref_mf
from mic_tpu.parallel import strips as ref_strips
from mic_tpu.parallel import strips_adaptive as ref_pica
from mic_tpu.parallel import wsi as ref_wsi
from mic_tpu.utils import io as ref_io
from mic_tpu_torch.models import rgb, single_frame
from mic_tpu_torch.ops import deltarle, fse_codec, predictors, pyramid, rle
from mic_tpu_torch.parallel import multiframe, strips, strips_adaptive, wsi
from mic_tpu_torch.tpu import ref_decode
from mic_tpu_torch.utils import io

TESTDATA = Path(__file__).resolve().parent.parent / "web" / "testdata"
CPU = torch.device("cpu")
SHAPES = [(37, 23), (64, 64), (96, 80)]  # (width, height)


def _image(w, h, seed, mv=4095):
    """A smooth seeded image with a flat patch and a few escapes."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((h, w)).cumsum(1).cumsum(0) * 3 + mv // 2
    img = np.clip(img, 0, mv).astype(np.uint16)
    img[h // 4 : h // 2, w // 4 : w // 2] = mv // 3
    img[rng.random((h, w)) < 0.01] = mv
    return img.ravel()


def _outcome(fn, *args):
    """The value, or the exception's type name and message."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 -- both sides must fail alike
        return (type(e).__name__, str(e))


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b):
        return all(_same(x, y) for x, y in zip(a, b))
    return a == b


# name -> (port function, mic_tpu function, arguments from (pixels, w, h, max_value))
_PX = lambda px, w, h, mv: (px, w, h, mv)  # noqa: E731
WRITERS = {
    "rle_compress": (rle.rle_compress, ref_rle.rle_compress, _PX),
    "delta_compress": (predictors.delta_compress, ref_pred.delta_compress, _PX),
    "grad_delta_compress": (predictors.grad_delta_compress, ref_pred.grad_delta_compress, _PX),
    "med_delta_compress": (predictors.med_delta_compress, ref_pred.med_delta_compress, _PX),
    "delta_zz_compress": (predictors.delta_zz_compress, ref_pred.delta_zz_compress, _PX),
    "delta_rle_compress": (deltarle.delta_rle_compress, ref_deltarle.delta_rle_compress, _PX),
    "grad_delta_rle_compress": (deltarle.grad_delta_rle_compress,
                                ref_deltarle.grad_delta_rle_compress, _PX),
    "zz_delta_rle_compress": (deltarle.zz_delta_rle_compress,
                              ref_deltarle.zz_delta_rle_compress, _PX),
    "fse_compress": (fse_codec.fse_compress, ref_fse_codec.fse_compress,
                     lambda px, w, h, mv: (px,)),
    "fse_compress_2state": (fse_codec.fse_compress_2state, ref_fse_codec.fse_compress_2state,
                            lambda px, w, h, mv: (px,)),
    "fse_compress_8state": (fse_codec.fse_compress_8state, ref_fse_codec.fse_compress_8state,
                            lambda px, w, h, mv: (px, 9)),
    "downsample2x_grey": (pyramid.downsample2x_grey, ref_pyramid.downsample2x_grey,
                          lambda px, w, h, mv: (px, w, h)),
    "compress_single_frame": (single_frame.compress_single_frame,
                              ref_sf.compress_single_frame, _PX),
    "compress_single_frame_4state": (single_frame.compress_single_frame_4state,
                                     ref_sf.compress_single_frame_4state, _PX),
    "compress_single_frame_8state": (single_frame.compress_single_frame_8state,
                                     ref_sf.compress_single_frame_8state, _PX),
    "compress_single_frame_rans8": (single_frame.compress_single_frame_rans8,
                                    ref_sf.compress_single_frame_rans8, _PX),
    "compress_single_frame_grad": (single_frame.compress_single_frame_grad,
                                   ref_sf.compress_single_frame_grad, _PX),
    "compress_residual_frame": (single_frame.compress_residual_frame,
                                ref_sf.compress_residual_frame,
                                lambda px, w, h, mv: (px, mv)),
    "compress_wsi_plane": (rgb.compress_wsi_plane, ref_rgb.compress_wsi_plane,
                           lambda px, w, h, mv: (px, w, h)),
    "compress_parallel_strips": (strips.compress_parallel_strips,
                                 ref_strips.compress_parallel_strips,
                                 lambda px, w, h, mv: (px, w, h, mv, 3)),
    "compress_parallel_strips_4state": (strips.compress_parallel_strips_4state,
                                        ref_strips.compress_parallel_strips_4state,
                                        lambda px, w, h, mv: (px, w, h, mv, 4)),
    "compress_parallel_strips_8state": (strips.compress_parallel_strips_8state,
                                        ref_strips.compress_parallel_strips_8state,
                                        lambda px, w, h, mv: (px, w, h, mv, 5)),
    "compress_parallel_strips_adaptive": (strips_adaptive.compress_parallel_strips_adaptive,
                                          ref_pica.compress_parallel_strips_adaptive,
                                          lambda px, w, h, mv: (px, w, h, mv, 3)),
    "adaptive_strip_boundaries": (strips_adaptive.adaptive_strip_boundaries,
                                  ref_pica.adaptive_strip_boundaries,
                                  lambda px, w, h, mv: (px, w, h, 5)),
    "write_mic1": (io.write_mic1, ref_io.write_mic1,
                   lambda px, w, h, mv: (w, h, px.tobytes()[:50])),
    "write_micr": (io.write_micr, ref_io.write_micr,
                   lambda px, w, h, mv: (w, h, px.tobytes()[:50])),
}


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_writer_matches_reference(name):
    got_fn, want_fn, args = WRITERS[name]
    cases = [(_image(w, h, 10 + i), w, h) for i, (w, h) in enumerate(SHAPES)]
    cases += [(np.full(40 * 6, 700, np.uint16), 40, 6),        # constant
              (_image(50, 1, 3), 50, 1),                       # one row
              (np.array([1, 9], np.uint16), 2, 1)]             # two pixels
    for px, w, h in cases:
        mv = int(px.max())
        got = _outcome(got_fn, *args(px, w, h, mv))
        want = _outcome(want_fn, *args(px, w, h, mv))
        assert _same(got, want), (name, w, h, got if isinstance(got, tuple) else None)


def test_rle_encoder_streaming_and_flush():
    """RleEncoder symbol by symbol, at small and large midCounts, with runs
    crossing the count-overflow flush."""
    rng = np.random.default_rng(21)
    data = np.repeat(rng.integers(0, 60, 300), rng.integers(1, 70, 300)).tolist()
    for mv in (15, 255, 4095, 65535):
        a, b = rle.RleEncoder(1, 1, mv), ref_rle.RleEncoder(1, 1, mv)
        for v in data:
            a.encode(v)
            b.encode(v)
        a.flush()
        b.flush()
        assert a.out == b.out and a.mid_count == b.mid_count
        assert np.array_equal(rle.rle_decompress(rle.rle_compress(data, 1, 1, 1023)),
                              np.array(data, np.uint16))


def test_standalone_predictor_codecs_round_trip():
    for i, (w, h) in enumerate(SHAPES):
        px = _image(w, h, 30 + i)
        mv = int(px.max())
        for name in ("delta", "grad_delta", "med_delta", "delta_zz"):
            blob = getattr(predictors, f"{name}_compress")(px, w, h, mv)
            got = getattr(predictors, f"{name}_decompress")(blob, w, h)
            assert np.array_equal(got, getattr(ref_pred, f"{name}_decompress")(blob, w, h))
            assert np.array_equal(got, px)
        for name in ("delta_rle", "grad_delta_rle", "zz_delta_rle"):
            stream = getattr(deltarle, f"{name}_compress")(px, w, h, mv)
            assert np.array_equal(getattr(deltarle, f"{name}_decompress")(stream, w, h), px)


def test_scratch_and_single_frame_decoders():
    px = _image(64, 64, 40)
    mv = int(px.max())
    s, r = fse_codec.ScratchU16(), ref_fse_codec.ScratchU16()
    s.TableLog = r.TableLog = 10
    for n in (1, 2, 4, 8):
        blob = s.compress(px, n_states=n)
        assert blob == r.compress(px, n_states=n)
        assert np.array_equal(s.decompress(blob), r.decompress(blob))
    blob = single_frame.compress_single_frame_grad(px, 64, 64, mv)
    for tier in ("auto", "native", "python"):  # auto and native: the C++ tier
        assert np.array_equal(single_frame.decode_frame(blob, 64, 64, "grad", tier), px)
    with pytest.raises(ValueError, match="python tier"):
        single_frame.decode_frame(blob, 64, 64, "med", "python")
    with pytest.raises(ValueError, match="native tier"):
        single_frame.decode_frame(blob, 64, 64, "gradient")
    res = single_frame.compress_residual_frame(px, mv)
    assert np.array_equal(single_frame.decompress_residual_frame(res),
                          ref_sf.decompress_residual_frame(res))


def test_io_readers_match():
    blob = io.write_mic1(5, 7, b"payload")
    assert io.read_mic1(blob) == ref_io.read_mic1(blob)
    micr = io.write_micr(5, 7, b"rgbpayload")
    assert io.read_micr(micr) == ref_io.read_micr(micr) == (5, 7, b"rgbpayload")
    for bad in (b"MICX" + bytes(12), b"MICR"):
        assert _outcome(io.read_micr, bad) == _outcome(ref_io.read_micr, bad)


def test_read_binary_image_matches(tmp_path):
    path = tmp_path / "im.bin"
    _image(37, 23, 50).astype("<u2").tofile(path)
    got, want = io.read_binary_image(str(path), 37, 23), ref_io.read_binary_image(str(path), 37, 23)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def _rgb(w, h, seed):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((h, w, 3)).cumsum(0).cumsum(1) * 4 + 128
    return np.clip(base, 0, 255).astype(np.uint8).ravel()


@pytest.mark.parametrize("transform", [True, False])
def test_rgb_tile_blobs_match(transform):
    for i, (w, h) in enumerate(SHAPES):
        px = _rgb(w, h, 60 + i)
        blob = rgb.compress_rgb_tile_blob(px, w, h, transform)
        assert blob == ref_rgb.compress_rgb_tile_blob(px, w, h, transform)
        got = rgb.decompress_rgb_tile_blob(blob, w, h, transform)
        assert np.array_equal(got, ref_rgb.decompress_rgb_tile_blob(blob, w, h, transform))
        assert np.array_equal(got, px)
    for plane in (np.zeros(64, np.uint16), np.full(64, 9, np.uint16),
                  np.arange(64, dtype=np.uint16)):
        blob = rgb.compress_wsi_plane(plane, 8, 8)
        assert np.array_equal(rgb.decompress_wsi_plane(blob, 8, 8, 64),
                              ref_rgb.decompress_wsi_plane(blob, 8, 8, 64))


def test_micr_matches_and_reads_back():
    px = _rgb(96, 80, 70)
    blob = io.write_micr(96, 80, rgb.compress_rgb(px, 96, 80))
    assert blob == ref_io.write_micr(96, 80, ref_rgb.compress_rgb(px, 96, 80))
    w, h, payload = io.read_micr(blob)
    assert np.array_equal(rgb.decompress_rgb(payload, w, h), px)
    assert np.array_equal(rgb.decompress_rgb(payload, w, h), ref_rgb.decompress_rgb(payload, w, h))


@pytest.mark.parametrize("temporal", [False, True])
def test_mic2_matches_and_reads_back(temporal):
    w, h = 64, 64
    img = _image(w, h, 80).reshape(h, w)
    frames = [img.ravel(), np.roll(img, 1, 0).ravel(), np.roll(img, 2, 1).ravel(), img.ravel()]
    mv = int(img.max())
    blob = multiframe.compress_multi_frame(frames, w, h, mv, temporal)
    assert blob == ref_mf.compress_multi_frame(frames, w, h, mv, temporal)
    got, hdr = multiframe.decompress_multi_frame(blob)
    want, _ = ref_mf.decompress_multi_frame(blob)
    assert hdr.temporal == temporal and len(got) == 4
    assert all(np.array_equal(g, r) and np.array_equal(g, f)
               for g, r, f in zip(got, want, frames))
    for k in (0, 2, 3):
        assert np.array_equal(multiframe.decompress_frame(blob, k)[0],
                              ref_mf.decompress_frame(blob, k)[0])
    assert _outcome(multiframe.decompress_frame, blob, 4)[0] == "ValueError"
    with pytest.raises(ValueError):
        multiframe.compress_multi_frame([], w, h, mv, temporal)


def test_mic2_device_format_frames_decode_on_the_given_device():
    """A MIC2 whose frames are MICW blobs: the host readers decode them on
    the device they are given, equal to mic_tpu's host decode."""
    blob = (TESTDATA / "series_dev_ind.mic2").read_bytes()
    got, _ = multiframe.decompress_multi_frame(blob, CPU)
    want, _ = ref_mf.decompress_multi_frame(blob)
    assert all(np.array_equal(g, r) for g, r in zip(got, want))
    assert np.array_equal(multiframe.decompress_frame(blob, 1, CPU)[0],
                          ref_mf.decompress_frame(blob, 1)[0])


@pytest.mark.parametrize("kind", ["rgb", "grey16", "grey8"])
def test_mic3_matches_and_reads_back(kind):
    w, h = 96, 80
    if kind == "rgb":
        data, ch, bps = _rgb(w, h, 90), 3, 8
    elif kind == "grey16":
        data, ch, bps = np.frombuffer(_image(w, h, 91).astype("<u2").tobytes(), np.uint8), 1, 16
    else:
        data, ch, bps = (_image(w, h, 92, mv=255)).astype(np.uint8), 1, 8
    for opts in (dict(tile_width=32, tile_height=32), dict(tile_width=64, tile_height=48,
                                                           pyramid_levels=2, workers=1)):
        blob = wsi.compress_wsi(data, w, h, ch, bps, wsi.WSIOptions(**opts))
        assert blob == ref_wsi.compress_wsi(data, w, h, ch, bps, ref_wsi.WSIOptions(**opts))
        hdr = wsi.read_wsi_header(blob)
        assert asdict(hdr) == asdict(ref_wsi.read_wsi_header(blob))
        for lvl, lv in enumerate(hdr.levels):
            for ty in range(lv.tiles_y):
                for tx in range(lv.tiles_x):
                    assert (wsi.decompress_wsi_tile(blob, lvl, tx, ty)
                            == ref_wsi.decompress_wsi_tile(blob, lvl, tx, ty))
            assert (wsi.decompress_wsi_region(blob, lvl, 3, 5, 40, 30)
                    == ref_wsi.decompress_wsi_region(blob, lvl, 3, 5, 40, 30))
        assert wsi.decompress_wsi_region(blob, 0, 0, 0, w, h) == data.tobytes()


def test_wsi_options_and_levels_match():
    for ch in (1, 3):
        a, b = wsi.WSIOptions(), ref_wsi.WSIOptions()
        a.defaults(ch)
        b.defaults(ch)
        assert asdict(a) == asdict(b)
    assert wsi.WSIOptions(color_transform=False).color_transform is False
    for w, h, tw, th in ((4608, 3584, 256, 256), (100, 30, 32, 32), (1, 1, 256, 256)):
        n = wsi.auto_level_count(w, h, tw, th)
        assert n == ref_wsi.auto_level_count(w, h, tw, th)
        assert ([asdict(x) for x in wsi.compute_levels(w, h, tw, th, n)]
                == [asdict(x) for x in ref_wsi.compute_levels(w, h, tw, th, n)])
    hdr = wsi.WSIHeader(8, 8, 8, 8, 1, 16, False, wsi.compute_levels(8, 8, 8, 8, 1))
    assert _outcome(wsi.write_mic3, hdr, []) == _outcome(
        ref_wsi.write_mic3, ref_wsi.WSIHeader(8, 8, 8, 8, 1, 16, False,
                                              ref_wsi.compute_levels(8, 8, 8, 8, 1)), [])
    for bps in (8, 16):
        raw = bytes(range(64))
        assert np.array_equal(wsi._bytes_to_u16(raw, bps), ref_wsi._bytes_to_u16(raw, bps))


def test_pics_and_pica_readers_match():
    for i, (w, h) in enumerate(SHAPES[1:]):
        px = _image(w, h, 100 + i)
        mv = int(px.max())
        pics = strips.compress_parallel_strips_4state(px, w, h, mv, 3)
        got = strips.decompress_parallel_strips(pics)
        assert np.array_equal(got[0], ref_strips.decompress_parallel_strips(pics)[0])
        assert np.array_equal(got[0], px)
        pica = strips_adaptive.compress_parallel_strips_adaptive(px, w, h, mv, 4)
        got = strips_adaptive.decompress_parallel_strips_adaptive(pica)
        want = ref_pica.decompress_parallel_strips_adaptive(pica)
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
        assert np.array_equal(got[0], px)
    for bad in (b"PICA" + bytes(4), b"PICS" + bytes(20)):
        assert (_outcome(strips_adaptive.decompress_parallel_strips_adaptive, bad)
                == _outcome(ref_pica.decompress_parallel_strips_adaptive, bad))


def test_fixture_list_is_every_reference_container():
    import json

    manifest = json.loads((TESTDATA / "manifest.json").read_text())
    host = [c["file"] for c in manifest if c["kind"] in ("mic1", "pics", "pica", "mic2", "micr",
                                                         "mic3")
            and not c["file"].startswith("series_dev")]
    assert sorted(host) == sorted(REF_FIXTURES) and len(REF_FIXTURES) == 19


@pytest.mark.parametrize("name", REF_FIXTURES)
def test_fixture_rewritten_byte_for_byte(name):
    """The writers as chip_smoke.py's phase 12 (a) drives them."""
    blob, n_in = _fixture_container(name)
    assert blob == (TESTDATA / name).read_bytes() and n_in > len(blob)


def test_writers_read_back_by_the_device_readers_on_cpu():
    """The port's MIC1 / PICS / MIC2 / MIC3 writers' output through
    tpu.ref_decode on the CPU (the tANS kernel's plain twin), equal to the
    input pixels."""
    w, h = 64, 64
    px = _image(w, h, 120)
    mv = int(px.max())
    blobs = [port.compress_single_frame(px, w, h, mv), port.compress_single_frame_4state(px, w, h, mv),
             port.compress_single_frame_8state(px, w, h, mv),
             port.compress_single_frame_rans8(px, w, h, mv)]
    outs = ref_decode.decompress_frames_device(blobs, [(w, h)] * 4, CPU)
    assert all(np.array_equal(o, px) for o in outs)
    grad = port.compress_single_frame_grad(px, w, h, mv)
    assert np.array_equal(ref_decode.decompress_frames_device([grad], [(w, h)], CPU, "grad")[0], px)
    pics = [port.compress_parallel_strips_4state(px, w, h, mv, 2),
            port.compress_parallel_strips_8state(px, w, h, mv, 2)]
    assert all(np.array_equal(o[0], px)
               for o in ref_decode.decompress_pics_device_many(pics, CPU))
    frames = [px, np.roll(px, 3), px[::-1].copy()]
    for temporal in (False, True):
        blob = port.compress_multi_frame(frames, w, h, mv, temporal)
        got, _ = ref_decode.decompress_mic2_device(blob, CPU)
        assert all(np.array_equal(g, f) for g, f in zip(got, frames))
    data = _rgb(w, h, 121)
    mic3 = port.compress_wsi(data, w, h, 3, 8, port.WSIOptions(tile_width=32, tile_height=16))
    hdr = port.read_wsi_header(mic3)
    assert ref_decode.decompress_wsi_level_device(mic3, 0, CPU) == data.tobytes()
    for lvl in range(1, len(hdr.levels)):
        lv = hdr.levels[lvl]
        assert (ref_decode.decompress_wsi_level_device(mic3, lvl, CPU)
                == port.decompress_wsi_region(mic3, lvl, 0, 0, lv.width, lv.height))
