"""The port's C++ host tier (``mic_tpu_torch.native`` over its own build of
``native/micfse.cpp``) against two references: ``mic_tpu``'s Python tier
and ``mic_tpu/native/micfse.cpp`` compiled here into a temporary
directory (``ref_lib``; nothing is built into ``mic_tpu/native/``).

* the C ABI one call at a time: ``entropy_compress`` at 1 / 2 / 4 / 8
  states, ``compress_frame`` at every predictor kind and at 2 / 4 / 8
  states and back, every ``web/testdata`` MIC1 and PICS fixture decoded
  to its ``.raw``, ``compress_strips`` / ``decompress_strips``,
  ``lane_encode`` (standard and with the alias ``slot_of``),
  ``normalize_write_count`` at tableLogs 5-16 and ``read_ncount``,
  each equal to the numpy twin or ``mic_tpu``'s Python tier and to the
  reference build;
* the call sites that now run it: ``decode_frame``, ingest's reference
  decode, the PICS writers, ``micw_compress`` and ``stage_encode_batch``
  against ``mic_tpu``'s;
* ``tests/test_native.py``'s hardening cases on the port's library;
* no fallback: where the library cannot be built, the first native call
  and ``decode_frame(tier="auto")`` raise.

Tolerance 0: these define the bytes of the formats.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mic_tpu_torch import _build, native
from mic_tpu_torch.models import single_frame
from mic_tpu_torch.ops import fse
from mic_tpu_torch.parallel import strips as pics
from mic_tpu_torch.tpu import device_rans as dr
from mic_tpu_torch.tpu import ingest
from mic_tpu_torch.tpu import rans_encode as renc
from mic_tpu_torch.tpu import strips as micw
from mic_tpu_torch.utils.io import read_mic1

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "web" / "testdata"
MIC1 = sorted(p.name for p in TESTDATA.glob("*.mic"))
PICS = sorted(p.name for p in TESTDATA.glob("*.pics"))
CPU = torch.device("cpu")


@pytest.fixture(scope="session")
def ref_lib(tmp_path_factory):
    """mic_tpu/native/micfse.cpp built with the port's flags into a
    temporary directory, every entry point declared."""
    out = tmp_path_factory.mktemp("ref_native") / "libmicfse_ref.so"
    subprocess.run([_build.host_compiler(), *_build.HOST_FLAGS, "-shared", "-o", str(out),
                    str(ROOT / "mic_tpu" / "native" / "micfse.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for name, (res, args) in _build._HOST_SIGNATURES.items():
        getattr(lib, name).restype = res
        getattr(lib, name).argtypes = args
    return lib


@pytest.fixture
def on_ref(ref_lib, monkeypatch):
    """Runs a port wrapper of ``native`` on the reference build."""
    def call(fn, *args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(native, "host_library", lambda: ref_lib)
            return fn(*args, **kwargs)
    return call


@pytest.fixture(scope="module")
def mt():
    """mic_tpu's Python tier (its library is not built where these run)."""
    pytest.importorskip("jax")
    from types import SimpleNamespace

    from mic_tpu.models import single_frame as rsf
    from mic_tpu.ops import deltarle as rdl
    from mic_tpu.ops import fse as rfse
    from mic_tpu.ops import fse_codec as rfc
    from mic_tpu.parallel import strips as rstrips
    from mic_tpu.tpu import device_rans as rdr
    from mic_tpu.tpu import strips as rst

    return SimpleNamespace(sf=rsf, dl=rdl, fse=rfse, fc=rfc, strips=rstrips, dr=rdr, st=rst)


def _image(h, w, seed, mx=4095):
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((h, w)).cumsum(0).cumsum(1) * 4).astype(np.int64)
    return (img - img.min()).clip(0, mx).astype(np.uint16).ravel()


def _raw(name):
    return np.fromfile(TESTDATA / f"{name.rsplit('.', 1)[0]}.raw", "<u2")


# ---------------------------------------------------------------------------
# the C ABI, one call at a time
# ---------------------------------------------------------------------------


def test_available_builds_the_library():
    assert native.available() is True
    lib = _build.host_library()
    assert lib.mic_native_version() == 1
    path = _build.host_build()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libmicfse-")
    assert path.name.endswith(".so") and path.is_file()


def test_source_is_mic_tpus_but_for_its_header():
    """micfse.cpp is a copy: past the header comment, line for line."""
    def body(p):
        text = p.read_text()
        return text[text.index("#include <cstdint>"):]
    assert body(ROOT / "mic_tpu_torch" / "native" / "micfse.cpp") == body(
        ROOT / "mic_tpu" / "native" / "micfse.cpp")


@pytest.mark.parametrize("n_states", [1, 2, 4, 8])
def test_entropy_compress(n_states, mt, on_ref):
    rng = np.random.default_rng(n_states)
    data = (rng.standard_normal(30000) * 30 + 500).clip(0, 2047).astype(np.uint16)
    py = {1: mt.fc.fse_compress, 2: mt.fc.fse_compress_2state, 4: mt.fc.fse_compress_4state,
          8: mt.fc.fse_compress_8state}[n_states](data)
    assert native.entropy_compress_native(data, n_states) == py
    assert on_ref(native.entropy_compress_native, data, n_states) == py
    assert np.array_equal(native.entropy_decompress_native(py, len(data) + 64), data)


def _python_frame(mt, px, w, h, kind, n_states):
    """mic_tpu's Python writer of a kind-``kind`` frame at ``n_states``."""
    mx = int(px.max())
    stream = {0: mt.dl.delta_rle_compress, 1: mt.dl.grad_delta_rle_compress,
              2: lambda *a: mt.dl._fused_compress(*a, "med"),
              3: mt.dl.zz_delta_rle_compress}[kind](px, w, h, mx)
    return mt.sf._fse_chain(np.asarray(stream, np.uint16), n_states)


@pytest.mark.parametrize("n_states", [2, 4, 8])
@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_compress_frame_every_kind(kind, n_states, mt, on_ref):
    w, h = 61, 96
    px = _image(h, w, 10 * kind + n_states)
    mx = int(px.max())
    blob = native.compress_frame_native(px, w, h, mx, kind=kind, n_states=n_states)
    assert blob == _python_frame(mt, px, w, h, kind, n_states)
    assert blob == on_ref(native.compress_frame_native, px, w, h, mx, kind=kind,
                          n_states=n_states)
    assert np.array_equal(native.decompress_frame_native(blob, w, h, kind), px)
    name = ("avg", "grad", "med", "zz")[kind]
    assert np.array_equal(single_frame.decode_frame(blob, w, h, name), px)
    if kind == 0:
        want = {2: mt.sf.compress_single_frame, 4: mt.sf.compress_single_frame_4state,
                8: mt.sf.compress_single_frame_8state}[n_states](px, w, h, mx)
        assert blob == want
    if kind == 1 and n_states == 2:
        assert blob == mt.sf.compress_single_frame_grad(px, w, h, mx)


@pytest.mark.parametrize("name", MIC1)
def test_mic1_fixture_decodes(name, mt, on_ref):
    w, h, _mv, payload = read_mic1((TESTDATA / name).read_bytes())[:4]
    raw = _raw(name)
    for tier in ("auto", "native"):
        assert np.array_equal(single_frame.decode_frame(payload, w, h, "avg", tier), raw)
    assert np.array_equal(on_ref(native.decompress_frame_native, payload, w, h), raw)
    assert np.array_equal(mt.sf.decode_frame(payload, w, h, "avg"), raw)
    got, gw, gh = ingest._decode_reference(payload, w, h, 0, CPU)
    assert (gw, gh) == (w, h) and np.array_equal(got, raw)


@pytest.mark.parametrize("name", PICS)
def test_pics_fixture_strips(name, on_ref):
    """Decode to the .raw, threaded and not; the writers rewrite the file
    (``mic_tpu``'s Python writers wrote it)."""
    blob = (TESTDATA / name).read_bytes()
    raw = _raw(name)
    for n_threads in (0, 1, 3):
        px, w, h = native.decompress_strips_native(blob, n_threads=n_threads)
        assert np.array_equal(px, raw)
    assert np.array_equal(on_ref(native.decompress_strips_native, blob)[0], raw)
    assert np.array_equal(ingest._decode_reference(blob, 0, 0, 0, CPU)[0], raw)
    n_states = 4 if "pics4" in name else 8
    mx, n = int(raw.max()), int(name.split(".")[0][-1])
    assert native.compress_strips_native(raw, w, h, mx, n_states=n_states, num_strips=n) == blob
    writer = {4: pics.compress_parallel_strips_4state, 8: pics.compress_parallel_strips_8state}
    assert writer[n_states](raw, w, h, mx, n) == blob


@pytest.mark.parametrize("n_states", [2, 4, 8])
def test_pics_writers_match_mic_tpu(n_states, mt, on_ref):
    """Seeded images, 1-4 strips, the last strip short; and an image whose
    strips the C++ tier finds incompressible (its None: the Python
    assembly)."""
    name = {2: "compress_parallel_strips", 4: "compress_parallel_strips_4state",
            8: "compress_parallel_strips_8state"}[n_states]
    for (w, h, strips), seed in zip(((80, 96, 4), (61, 50, 3), (64, 64, 1)), range(3)):
        px = _image(h, w, 40 + seed + n_states)
        want = getattr(mt.strips, name)(px, w, h, int(px.max()), num_strips=strips)
        assert getattr(pics, name)(px, w, h, int(px.max()), num_strips=strips) == want
        assert pics._compress_strips_python(px, w, h, int(px.max()), strips, n_states) == want
        assert on_ref(native.compress_strips_native, px, w, h, int(px.max()),
                      n_states=n_states, num_strips=strips) == want
        out, _w, _h = native.decompress_strips_native(want)
        assert np.array_equal(out, px)
    # u16 noise: the C++ tier finds a strip incompressible (None), and the
    # Python assembly it falls through to raises as mic_tpu's writer does
    noise = np.random.default_rng(0).integers(0, 65536, 256).astype(np.uint16)
    mx = int(noise.max())
    assert native.compress_strips_native(noise, 16, 16, mx, n_states=n_states,
                                         num_strips=2) is None
    with pytest.raises(Exception) as want:
        getattr(mt.strips, name)(noise, 16, 16, mx, num_strips=2)
    with pytest.raises(want.type, match=str(want.value)):
        getattr(pics, name)(noise, 16, 16, mx, num_strips=2)


def _streams():
    rng = np.random.default_rng(21)
    for n, p, cap in ((5000, 0.06, 800), (40000, 0.2, 90), (9000, 0.02, 2000)):
        yield np.minimum(rng.geometric(p, n), cap).astype(np.uint16)
    yield (np.abs(rng.standard_normal(20000)) * 300).astype(np.uint16)


@pytest.mark.parametrize("lanes", [8, 64, 128, 512])
@pytest.mark.parametrize("alias", [False, True], ids=["standard", "alias"])
def test_lane_encode_equals_numpy(alias, lanes, mt, on_ref):
    for data in _streams():
        n = len(data)
        counts, _mx, sl = fse.histogram(data)
        if alias:
            kept, esc, tl, _hdr, freq, cumul, al = dr.alias_encode_plan(
                counts, sl, n, fse.DEFAULT_TABLE_LOG, None)
            syms = dr._alias_apply(data, kept, esc)[0]
            slot_of = al["slot_of"].astype(np.uint64)
        else:
            tl = fse.optimal_table_log(fse.DEFAULT_TABLE_LOG, n, sl)
            norm, _hdr = dr._norm_and_header(counts, n, tl, sl)
            freq, cumul = dr.encode_tables(norm, tl)
            syms, slot_of = data, None
        sym64 = np.asarray(syms, np.int64)
        got = dr._lane_encode(sym64, n, lanes, tl, freq, cumul, slot_of)
        want = dr._lane_encode_numpy(sym64, n, lanes, tl, freq, cumul, slot_of)
        ref = on_ref(dr._lane_encode, sym64, n, lanes, tl, freq, cumul, slot_of)
        for a in (want, ref):
            assert np.array_equal(got[0], a[0]) and got[0].dtype == a[0].dtype
            assert np.array_equal(got[1], a[1]) and got[1].dtype == a[1].dtype
        try:
            want = mt.dr.mict_encode(data, lanes=lanes, alias=alias)
        except mt.fse.IncompressibleError:  # the lanes' states outweigh the stream
            with pytest.raises(fse.IncompressibleError):
                dr.mict_encode(data, lanes=lanes, alias=alias)
            continue
        blob = dr.mict_encode(data, lanes=lanes, alias=alias)
        assert blob == want and np.array_equal(dr.mict_decode_numpy(blob), data)


def test_lane_encode_past_the_native_shapes(mt):
    """More than 4096 lanes or tableLog 16: mic_lane_encode refuses them
    (as mic_tpu's library does), and the port's host encoder writes them
    through the numpy twin, mic_tpu's Python tier's bytes."""
    data = next(_streams())
    n = len(data)
    counts, _mx, sl = fse.histogram(data)
    for lanes, tl in ((8192, 11), (64, 16), (4096, 15)):
        norm, _hdr = dr._norm_and_header(counts, n, tl, sl)
        freq, cumul = dr.encode_tables(norm, tl)
        sym64 = data.astype(np.int64)
        got = dr._lane_encode(sym64, n, lanes, tl, freq, cumul)
        want = mt.dr._lane_encode(sym64, n, lanes, tl, freq, cumul)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        native_shape = lanes <= dr.NATIVE_MAX_LANES and tl <= dr.NATIVE_MAX_TABLE_LOG
        if native_shape:
            assert np.array_equal(native.lane_encode_native(data, lanes, tl, freq, cumul)[1],
                                  got[1])
        else:
            with pytest.raises(ValueError, match="native lane encode failed"):
                native.lane_encode_native(data, lanes, tl, freq, cumul)


def _histogram_cases():
    rng = np.random.default_rng(5)
    for t in range(36):
        n = int(rng.integers(100, 30000))
        if t % 3 == 0:
            d = np.minimum(rng.geometric(rng.uniform(0.01, 0.5), n), 2000)
        elif t % 3 == 1:
            d = (rng.standard_normal(n) * rng.uniform(5, 700) + 1000).clip(0, 4095)
        else:
            d = rng.integers(0, int(rng.integers(2, 300)), n)
        yield d.astype(np.uint16)


@pytest.mark.parametrize("table_log", list(range(5, 17)))
def test_normalize_write_count_equals_numpy(table_log, mt, on_ref):
    """The native pair, its numpy twin and mic_tpu's Python pair: the same
    norm and header, or the same rejection (native None, numpy
    ValueError)."""
    checked = rejected = 0
    for data in _histogram_cases():
        counts, mc, sl = fse.histogram(data)
        n = len(data)
        if mc == n or sl < 2 or (1 << table_log) < np.count_nonzero(counts):
            continue
        nat = native.normalize_write_count_native(counts, n, table_log, sl)
        assert _outcome(on_ref, native.normalize_write_count_native,
                        counts, n, table_log, sl) == _outcome(None, lambda: nat)
        try:
            want = mt.dr._norm_and_header(counts, n, table_log, sl)
        except ValueError:
            assert nat is None
            with pytest.raises(ValueError):
                dr._norm_and_header(counts, n, table_log, sl)
            rejected += 1
            continue
        numpy_twin = dr._norm_and_header_numpy(counts, n, table_log, sl)
        got = dr._norm_and_header(counts, n, table_log, sl)
        for a in (numpy_twin, nat):
            assert np.array_equal(got[0], a[0]) and got[0].dtype == a[0].dtype
            assert got[1] == a[1]
        assert np.array_equal(got[0], want[0]) and got[0].dtype == want[0].dtype
        assert got[1] == want[1]
        checked += 1
    assert checked >= 3 and checked + rejected >= 6


def _outcome(on_ref, fn, *args):
    res = on_ref(fn, *args) if on_ref else fn(*args)
    return None if res is None else (res[0].tolist(), res[1])


def test_read_ncount_equals_python(mt):
    """Every header of the cases above and the MICW fixtures' strips:
    the native reader's parse is ``ops.fse.read_ncount``'s (norm widened
    by ``mict_parse``); damaged headers: where the native reader rejects
    (None), the Python one raises, and ``mict_parse`` raises it."""
    headers = []
    for data in _histogram_cases():
        counts, mc, sl = fse.histogram(data)
        tl = fse.optimal_table_log(11, len(data), sl)
        nat = native.normalize_write_count_native(counts, len(data), tl, sl)
        if nat is not None:
            headers.append(nat[1] + b"\0" * 8)
    for path in sorted(TESTDATA.glob("*.micw")):
        for st in micw.micw_parse(path.read_bytes())[7]:
            if st[0][:1] == b"\xff":
                headers.append(st[0][18 if st[0][1] == 0x41 else 12:])
    assert len(headers) > 30
    for hdr in headers:
        got, want = native.read_ncount_native(hdr), fse.read_ncount(hdr)
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
        assert got[1:] == mt.fse.read_ncount(hdr)[1:]
    rng = np.random.default_rng(6)
    rejected = 0
    for _ in range(200):
        b = bytearray(headers[int(rng.integers(0, len(headers)))][:40])
        b[int(rng.integers(0, min(len(b), 12)))] ^= 1 << int(rng.integers(0, 8))
        got = native.read_ncount_native(bytes(b))
        if got is None:
            rejected += 1
            with pytest.raises(ValueError):
                fse.read_ncount(bytes(b))
    assert rejected > 0


# ---------------------------------------------------------------------------
# the call sites that run the C++ tier, against mic_tpu's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_ingest_tiers_agree(kind, mt):
    """A frame of each kind and a PICS container: the native tier (the
    default), the python tier and, for kinds 0-1, the device tier (tANS
    twin on the CPU) give the pixels; a PICS container decodes as avg."""
    w, h = 96, 64
    px = _image(h, w, 70 + kind)
    blob = _python_frame(mt, px, w, h, kind, 4)
    tiers = ("native", "python", "device")
    for entropy in tiers:
        got, gw, gh = ingest._decode_reference(blob, w, h, kind, CPU, entropy=entropy)
        assert (gw, gh) == (w, h) and np.array_equal(got, px), entropy
    container = mt.strips.compress_parallel_strips_4state(px, w, h, int(px.max()), 2)
    for entropy in tiers[:2] if kind == 1 else tiers:  # the device tier honours grad
        got, gw, gh = ingest._decode_reference(container, 0, 0, kind, CPU, entropy=entropy)
        assert (gw, gh) == (w, h) and np.array_equal(got, px), entropy
    with pytest.raises(ValueError, match="entropy tier"):
        ingest._decode_reference(blob, w, h, kind, CPU, entropy="cpp")


def test_micw_host_encoder_matches_mic_tpu(mt):
    """The host micw_compress (native _lane_encode and _norm_and_header),
    at 128 and 64 lanes, standard and alias."""
    px = _raw("MR_dev")
    for lanes in (128, 64):
        for entropy in ("standard", "alias"):
            got = micw.micw_compress(px, 256, 256, int(px.max()), entropy=entropy, lanes=lanes)
            assert got == mt.st.micw_compress(px, 256, 256, int(px.max()), entropy=entropy,
                                              lanes=lanes)
            assert np.array_equal(micw.micw_decompress_host(got)[0], px)


@pytest.mark.parametrize("alias", [False, True], ids=["standard", "alias"])
def test_stage_encode_batch_headers_match_mic_tpu(alias, mt):
    """The device encode's staging: each stream's tableLog and ncount
    header equal mic_tpu's Python encoder's blob header."""
    streams = list(_streams())
    staged = renc.stage_encode_batch(streams, alias=alias, on_error="none")
    assert len(staged.slot_of) >= 3
    for (n, tl, header, _ranks, _esc), si in zip(staged.metas, staged.slot_of):
        s = streams[si]
        blob = mt.dr.mict_encode(s, lanes=128, alias=alias)
        hdr = 18 if alias else 12
        assert (n, tl) == (len(s), blob[3]) and blob[hdr:hdr + len(header)] == header


# ---------------------------------------------------------------------------
# tests/test_native.py's hardening cases, on the port's library
# ---------------------------------------------------------------------------


def test_corrupt_header_rejected():
    w, h, _mv, payload = read_mic1((TESTDATA / "CT_2s.mic").read_bytes())[:4]
    blob = bytearray(payload)
    blob[8] ^= 0xFF  # header corruption
    with pytest.raises(ValueError):
        native.decompress_frame_native(bytes(blob), w, h, native.PRED_AVG)
    with pytest.raises(ValueError):
        single_frame.decode_frame(bytes(blob), w, h)


def test_rle_amplification_bounded():
    """Max-width same-run blocks must not expand past the caller's token
    bound (each 2-word block could expand to 16383 tokens)."""
    k = 30000
    words = np.empty(1 + 2 * k, dtype=np.uint16)
    words[0] = 0x7FFF  # rle maxValue -> mid = 0x3FFF
    words[1::2] = 0x3FFE  # same-run of 16382
    words[2::2] = 123
    blob = native.entropy_compress_native(words, 4)
    t0 = time.perf_counter()
    try:  # a bounded garbage frame or an error, never an OOM or a stall
        native.decompress_frame_native(bytes(blob), 128, 128, native.PRED_AVG)
    except ValueError:
        pass
    assert time.perf_counter() - t0 < 2.0


def test_noise_rejected_not_hung(mt):
    arr = np.random.default_rng(0).integers(0, 65536, 256).astype(np.uint16)
    with pytest.raises(Exception):
        mt.sf.compress_single_frame_4state(arr, 16, 16, int(arr.max()))
    with pytest.raises(ValueError):
        native.compress_frame_native(arr, 16, 16, int(arr.max()), kind=native.PRED_AVG,
                                     n_states=4)


def test_worker_pool_dispatch_subprocess():
    """MIC_POOL_THREADS=4 forces the pool's dispatch path: a threaded PICS
    container round-tripped repeatedly by four concurrent callers."""
    script = r"""
import threading
import numpy as np
from mic_tpu_torch import native
r = np.random.default_rng(1)
px = (r.standard_normal(512*256)*300 + 1000).clip(0, 4095).astype(np.uint16)
blob = native.compress_strips_native(px, 512, 256, int(px.max()), kind=native.PRED_AVG,
                                     n_states=4, num_strips=8)
assert blob is not None
errs = []
def w():
    try:
        for _ in range(10):
            out, _, _ = native.decompress_strips_native(blob)
            assert np.array_equal(out, px)
    except Exception as e:
        errs.append(repr(e))
ts = [threading.Thread(target=w) for _ in range(4)]
[t.start() for t in ts]; [t.join() for t in ts]
assert not errs, errs
assert native.compress_strips_native(px, 512, 256, int(px.max()), kind=native.PRED_AVG,
                                     n_states=4, num_strips=8) == blob
print("POOL_OK")
"""
    native.available()  # built here, so the subprocess only loads it
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                       text=True, timeout=120, env={**os.environ, "MIC_POOL_THREADS": "4"})
    assert r.returncode == 0, r.stderr[-500:]
    assert "POOL_OK" in r.stdout


def test_kind_and_states_keyword_only():
    img = _image(16, 16, 3, 1023)
    mx = int(img.max())
    with pytest.raises(TypeError):
        native.compress_frame_native(img, 16, 16, mx, 4)  # noqa
    with pytest.raises(ValueError, match="n_states=4"):
        native.compress_frame_native(img, 16, 16, mx, kind=4)
    with pytest.raises(ValueError, match="n_states"):
        native.compress_frame_native(img, 16, 16, mx, n_states=3)
    with pytest.raises(TypeError):
        native.compress_strips_native(img, 16, 16, mx, 4)  # noqa


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_build_raises_and_nothing_falls_back(compiler, tmp_path, monkeypatch):
    """With ``CXX`` a missing binary (or one that fails) and an empty build
    directory, the first native call raises ``RuntimeError``, and so do
    ``decode_frame(tier="auto")``, ingest's default tier, the PICS writer
    and ``mict_parse``: none of them runs Python instead."""
    w, h, _mv, payload = read_mic1((TESTDATA / "MR_2s.mic").read_bytes())[:4]
    strip = micw.micw_parse((TESTDATA / "MR_dev.micw").read_bytes())[7][0][0]
    px = _raw("MR_2s")
    cxx = str(tmp_path / "no-such-c++") if compiler == "missing" else shutil.which("false")
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="compiler|compile"):
            native.available()
        calls = [lambda: single_frame.decode_frame(payload, w, h),
                 lambda: single_frame.decode_frame(payload, w, h, "avg", "native"),
                 lambda: ingest._decode_reference(payload, w, h, 0, CPU),
                 lambda: pics.compress_parallel_strips_4state(px, w, h, int(px.max()), 4),
                 lambda: dr.mict_parse(strip),
                 lambda: native.read_ncount_native(b"\0" * 16)]
        for call in calls:
            with pytest.raises(RuntimeError):
                call()
        assert not list((tmp_path / "build").glob("libmicfse-*"))
        # the python tier needs no library
        assert np.array_equal(single_frame.decode_frame(payload, w, h, "avg", "python"), px)
    finally:
        _build.host_library.cache_clear()
