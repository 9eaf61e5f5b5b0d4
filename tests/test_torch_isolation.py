"""The port imports nothing of mic_tpu, and its copies of mic_tpu.ops are
pinned to the originals.

* ``import mic_tpu_torch``, ``import chip_smoke``, ``import
  mic_tpu_torch.native`` and the import of each module of the port that
  the package does not load itself load no module of ``mic_tpu`` and no
  jax (a fresh interpreter, with ``CXX`` naming no compiler: no import
  builds the C++ host tier), and no source of the port names ``mic_tpu``
  or jax in an import;
* ``mic_tpu_torch.ops.fse`` against ``mic_tpu.ops.fse``, the port's C++
  pair (``mic_tpu_torch.native``) and the C++ pair of ``mic_tpu.native``
  where it is built: histograms, tableLog choice, normalization, and the
  ncount header written and read back at tableLogs 5-16, byte for byte;
* ``mic_tpu_torch.ops.predictors`` and ``.rle`` against
  ``mic_tpu.ops.predictors`` / ``.rle`` on seeded images and streams,
  both sides (the decode side serves the reference formats), and the
  decode-side copies of ``deltarle``, ``color`` and ``models.rgb``.
  ``bitio``, ``fse_codec`` and ``rans`` are pinned in
  ``tests/test_torch_tans_decode.py`` (their encoders, which the dry run
  uses, in ``tests/test_torch_mesh.py``); the reference formats' writers
  and host readers in ``tests/test_torch_host_writers.py``, the DICOM
  reader in ``tests/test_torch_dicom.py``; the host MICW / MWR3 decoders
  and the SoA-RLE helpers in ``tests/test_torch_host_oracle.py``; the
  wavelet, Huffman and gap-removal pipelines in
  ``tests/test_torch_wavelet_huffman_gap.py``; the comparators in
  ``tests/test_torch_comparators.py``.

Tolerance 0: these define the bytes of the format.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mic_tpu.models import rgb as ref_rgb
from mic_tpu.ops import color as ref_color
from mic_tpu.ops import deltarle as ref_deltarle
from mic_tpu.ops import fse as ref_fse
from mic_tpu.ops import predictors as ref_pred
from mic_tpu.ops import rle as ref_rle
from mic_tpu_torch.models import rgb
from mic_tpu_torch.ops import color, deltarle, fse, predictors, rle

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("module", ["mic_tpu_torch", "chip_smoke",
                                    "mic_tpu_torch.tpu.ref_decode", "mic_tpu_torch.tpu.ingest",
                                    "mic_tpu_torch.cli", "mic_tpu_torch.tpu.kernels",
                                    "mic_tpu_torch.tpu.wsi_device",
                                    "mic_tpu_torch.tpu.scan_decode",
                                    "mic_tpu_torch.tpu.verify",
                                    "mic_tpu_torch.tpu.decode",
                                    "mic_tpu_torch.tpu.mesh", "mic_tpu_torch.dryrun",
                                    "mic_tpu_torch.native",
                                    "mic_tpu_torch.utils.dicom",
                                    "mic_tpu_torch.parallel.strips_adaptive",
                                    "mic_tpu_torch.models.wavelet_pipeline, "
                                    "mic_tpu_torch.ops.gapremoval, mic_tpu_torch.utils.charls, "
                                    "mic_tpu_torch.utils.j2k"])
def test_import_loads_no_mic_tpu(module):
    code = (f"import sys, {module}; "
            "bad = [m for m in sys.modules if m == 'mic_tpu' or m.startswith('mic_tpu.') "
            "or m == 'jax' or m.startswith('jax.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {**os.environ, "CXX": str(ROOT / "build" / "no-such-compiler")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_mic_tpu():
    pat = re.compile(r"^\s*(from|import)\s+(mic_tpu|jax)(\.|\s|$)", re.M)
    files = (sorted((ROOT / "mic_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "scripts").glob("*.py")))
    assert len(files) >= 10
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {f"mic_tpu_torch/{m}.py" for m in ("ops/wavelet", "ops/huffman", "ops/gapremoval",
                                               "models/wavelet_pipeline", "utils/charls",
                                               "utils/j2k")} <= names
    bad = [str(f.relative_to(ROOT)) for f in files if pat.search(f.read_text())]
    assert not bad, bad


def _histograms():
    """Seeded symbol streams: geometric, wide noise, a two-symbol stream,
    sparse large values."""
    rng = np.random.default_rng(0)
    yield np.minimum(rng.geometric(0.05, 5000), 400).astype(np.uint16)
    yield (np.abs(rng.standard_normal(60000)) * 1500).astype(np.uint16)
    yield rng.integers(0, 2, 3000).astype(np.uint16)
    yield (rng.integers(0, 40, 20000) * 1637).astype(np.uint16)
    yield np.minimum(rng.geometric(0.3, 200), 30).astype(np.uint16)


def test_histogram_and_table_log_match():
    for data in _histograms():
        got, want = fse.histogram(data), ref_fse.histogram(data)
        assert np.array_equal(got[0], want[0]) and got[0].dtype == want[0].dtype
        assert got[1:] == want[1:]
    for tl in (5, 9, 11, 12, 13, 16):
        for n in (2, 100, 4096, 70000, 1 << 20):
            for sl in (2, 50, 300, 600, 5000, 65536):
                assert fse.optimal_table_log(tl, n, sl) == ref_fse.optimal_table_log(tl, n, sl)


@pytest.mark.parametrize("table_log", list(range(5, 17)))
def test_normalize_and_ncount_round_trip(table_log):
    """normalize_count, write_count and read_ncount at every tableLog,
    against mic_tpu.ops.fse, the port's C++ pair and, where built,
    mic_tpu.native."""
    from mic_tpu import native

    from mic_tpu_torch import native as port_native

    checked = 0
    for data in _histograms():
        counts, _mx, sl = ref_fse.histogram(data)
        n = data.size
        if (1 << table_log) < np.count_nonzero(counts):
            continue
        try:
            want = ref_fse.normalize_count(counts, n, table_log, sl)
        except ValueError:
            with pytest.raises(ValueError):
                fse.normalize_count(counts, n, table_log, sl)
            continue
        got = fse.normalize_count(counts, n, table_log, sl)
        assert np.array_equal(got, want) and got.dtype == want.dtype
        if int(np.abs(want).sum()) != (1 << table_log):
            continue
        hdr = fse.write_count(got, sl, table_log)
        assert hdr == ref_fse.write_count(want, sl, table_log)
        back = fse.read_ncount(hdr + b"\0" * 8)
        ref_back = ref_fse.read_ncount(hdr + b"\0" * 8)
        assert np.array_equal(back[0], ref_back[0]) and back[1:] == ref_back[1:]
        assert np.array_equal(back[0], want) and back[1:3] == (sl, table_log)
        nat = port_native.normalize_write_count_native(counts, n, table_log, sl)
        assert nat is not None and np.array_equal(nat[0], got) and nat[1] == hdr
        nat_back = port_native.read_ncount_native(hdr + b"\0" * 8)
        assert np.array_equal(nat_back[0], back[0]) and nat_back[1:] == back[1:]
        if native.available():
            nat = native.normalize_write_count_native(counts, n, table_log, sl)
            assert nat is not None and np.array_equal(nat[0], got) and nat[1] == hdr
            nat_back = native.read_ncount_native(hdr + b"\0" * 8)
            assert np.array_equal(nat_back[0], back[0]) and nat_back[1:] == back[1:]
        checked += 1
    assert checked >= 2


def _outcome(fn, data):
    try:
        norm, *rest = fn(data)
        return ("ok", norm.tolist(), rest)
    except ValueError as e:
        return ("ValueError", str(e))


def test_read_ncount_damaged_headers_like_reference():
    """Truncated, saturated, zeroed and bit-flipped headers: the same
    error, or the same parse, on both sides."""
    hdr = fse.write_count(fse.normalize_count(*_counts_of(np.arange(600) % 37), 10, 37), 37, 10)
    rng = np.random.default_rng(6)
    cases = [hdr[:2], bytes([0xFF]) * 6, bytes(len(hdr) + 4), hdr[:3] + bytes(5)]
    for _ in range(20):
        b = bytearray(hdr + bytes(4))
        b[int(rng.integers(0, len(hdr)))] ^= 1 << int(rng.integers(0, 8))
        cases.append(bytes(b))
    outcomes = [_outcome(fse.read_ncount, b) for b in cases]
    assert outcomes == [_outcome(ref_fse.read_ncount, b) for b in cases]
    assert {o[0] for o in outcomes} == {"ok", "ValueError"}


def _counts_of(data):
    counts, _mx, _sl = ref_fse.histogram(np.asarray(data, np.uint16))
    return counts, len(data)


def test_errors_are_the_ports_own():
    assert fse.IncompressibleError is not ref_fse.IncompressibleError
    assert issubclass(fse.UseRLEError, Exception)
    assert (fse.MAX_TABLE_LOG, fse.DEFAULT_TABLE_LOG, fse.MIN_TABLE_LOG) == (
        ref_fse.MAX_TABLE_LOG, ref_fse.DEFAULT_TABLE_LOG, ref_fse.MIN_TABLE_LOG)


@pytest.mark.parametrize("kind", ["avg", "med", "grad"])
def test_predictor_encode_matches(kind):
    rng = np.random.default_rng(3)
    for h, w, mv in ((7, 13, 4095), (32, 200, 65535), (1, 5, 255), (20, 1, 1023)):
        img = (rng.standard_normal((h, w)).cumsum(1) * 30 + mv // 2).clip(0, mv)
        img = img.astype(np.uint16)
        img[rng.random((h, w)) < 0.05] = mv
        got = predictors.predictor_encode(img.ravel(), w, h, mv, kind)
        want = ref_pred.predictor_encode(img.ravel(), w, h, mv, kind)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_zigzag_delta_params_and_escapes_match():
    x = np.arange(-32768, 32768, 7, dtype=np.int64).astype(np.int16)
    assert np.array_equal(predictors.zigzag(x), ref_pred.zigzag(x))
    for mv in (1, 2, 255, 256, 4095, 65535):
        assert predictors.delta_params(mv) == ref_pred.delta_params(mv)
    rng = np.random.default_rng(4)
    coded = rng.integers(0, 500, 300).astype(np.uint16)
    raw = rng.integers(0, 4096, 300).astype(np.uint16)
    esc = rng.random(300) < 0.2
    assert np.array_equal(predictors._interleave_escapes(coded, raw, esc, 4095),
                          ref_pred._interleave_escapes(coded, raw, esc, 4095))


@pytest.mark.parametrize("mid,min_same", [(127, 3), (1023, 3), (16383, 16), (16383, 3)])
def test_soa_encode_matches(mid, min_same):
    rng = np.random.default_rng(mid + min_same)
    streams = [np.repeat(rng.integers(0, 300, 800), rng.integers(1, 40, 800)).astype(np.uint16),
               np.full(40000, 7, np.uint16), rng.integers(0, 5, 3000).astype(np.uint16),
               np.zeros(0, np.uint16)]
    for t in streams:
        got = rle.soa_encode(t, mid, min_same=min_same)
        want = ref_rle.soa_encode(t, mid, min_same=min_same)
        assert np.array_equal(got[0], want[0]) and got[0].dtype == want[0].dtype
        assert got[1:] == want[1:]


def _rle_streams():
    """Seeded reference-format RLE streams: a Compress()-style stream with
    its length prefix, and the fused Delta+RLE layout of three predictors."""
    rng = np.random.default_rng(8)
    data = np.repeat(rng.integers(0, 900, 400), rng.integers(1, 30, 400)).astype(np.uint16)
    yield "plain", ref_rle.rle_compress(data, len(data), 1, 1023)
    img = (rng.standard_normal((24, 40)).cumsum(1) * 20 + 2000).clip(0, 4095).astype(np.uint16)
    img[3:9, 5:30] = 77
    for kind, comp in (("avg", ref_deltarle.delta_rle_compress),
                       ("grad", ref_deltarle.grad_delta_rle_compress),
                       ("zz", ref_deltarle.zz_delta_rle_compress)):
        yield kind, comp(img.ravel(), 40, 24, int(img.max()))


def test_rle_and_predictor_decode_match():
    """rle_expand / rle_decompress / rle_decompress_stream, parse_escaped,
    predictor_decode (avg, grad, med, zz), the fused Delta+RLE decoders
    and unzigzag / temporal_delta_decode, against mic_tpu.ops."""
    for kind, stream in _rle_streams():
        if kind == "plain":
            got = rle.rle_decompress(stream)
            assert got.dtype == np.uint16 and np.array_equal(got, ref_rle.rle_decompress(stream))
            for n in (None, 5, 10**6):
                a, b = rle.rle_expand(stream, 3, 511, n), ref_rle.rle_expand(stream, 3, 511, n)
                assert np.array_equal(a[0], b[0]) and a[1] == b[1]
            continue
        a, b = rle.rle_decompress_stream(stream), ref_rle.rle_decompress_stream(stream)
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]
        mv = int(a[0][0])
        _thr, delim = predictors.delta_params(mv)
        vals, raw = predictors.parse_escaped(a[0][1:], delim, 40 * 24)
        rvals, rraw = ref_pred.parse_escaped(a[0][1:], delim, 40 * 24)
        assert np.array_equal(vals, rvals) and np.array_equal(raw, rraw)
        for pk in ("avg", "grad", "med", "zz"):
            assert np.array_equal(predictors.predictor_decode(vals, raw, 40, 24, mv, pk),
                                  ref_pred.predictor_decode(vals, raw, 40, 24, mv, pk))
        if kind in ("avg", "grad"):
            fn = "delta_rle_decompress" if kind == "avg" else "grad_delta_rle_decompress"
            assert np.array_equal(getattr(deltarle, fn)(stream, 40, 24),
                                  getattr(ref_deltarle, fn)(stream, 40, 24))
    with pytest.raises(ValueError):
        predictors.parse_escaped(np.zeros(3, np.uint16), 7, 10)
    rng = np.random.default_rng(12)
    ux = rng.integers(0, 65536, 5000).astype(np.uint16)
    prev = rng.integers(0, 65536, 5000).astype(np.uint16)
    assert np.array_equal(predictors.unzigzag(ux), ref_pred.unzigzag(ux))
    assert np.array_equal(predictors.temporal_delta_decode(ux, prev),
                          ref_pred.temporal_delta_decode(ux, prev))
    assert np.array_equal(predictors.temporal_delta_decode(ux, None), ux)


def test_color_and_plane_modes_match():
    rng = np.random.default_rng(13)
    y, co, cg = (rng.integers(0, 511, 600).astype(np.uint16) for _ in range(3))
    assert np.array_equal(color.ycocgr_inverse(y, co, cg, 30, 20),
                          ref_color.ycocgr_inverse(y, co, cg, 30, 20))
    rgb_px = rng.integers(0, 256, 600 * 3).astype(np.uint8)
    planes = ref_color.ycocgr_forward(rgb_px, 30, 20)
    assert np.array_equal(color.ycocgr_inverse(*planes, 30, 20), rgb_px)
    assert (rgb.PLANE_CONSTANT_ZERO, rgb.PLANE_CONSTANT, rgb.PLANE_COMPRESSED,
            rgb.PLANE_RAW) == (ref_rgb.PLANE_CONSTANT_ZERO, ref_rgb.PLANE_CONSTANT,
                               ref_rgb.PLANE_COMPRESSED, ref_rgb.PLANE_RAW)
