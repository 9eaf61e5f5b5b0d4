"""The port's MICW batch decode (MicwDecodePlan / micw_decode_many) on
the CPU against the expected pixels, mic_tpu's host decoder and mic_tpu's
own plan (Pallas interpret mode).  Tolerance 0: lossless codec."""

from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from mic_tpu.tpu import strips as ref_st  # noqa: E402
from mic_tpu_torch import MicwDecodePlan, micw_decode_many  # noqa: E402
from mic_tpu_torch.tpu import strips as st  # noqa: E402
from mic_tpu_torch.tpu.device_rans import mict_parse  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "web" / "testdata"
CPU = torch.device("cpu")

# (container, expected pixels, width, height)
FIXTURES = {
    "CT_dev": (TESTDATA / "CT_dev.micw", TESTDATA / "CT_dev.raw", 512, 512),
    "MR_dev": (TESTDATA / "MR_dev.micw", TESTDATA / "MR_dev.raw", 256, 256),
    "MR_dev_alias": (TESTDATA / "MR_dev_alias.micw", TESTDATA / "MR_dev_alias.raw", 256, 256),
    "wide_banded": (TESTDATA / "wide_banded.micw", TESTDATA / "wide_banded.raw", 1024, 512),
    "CT_dev_alias": (ROOT / "tests" / "data" / "torch_port" / "CT_dev_alias.micw",
                     TESTDATA / "CT_dev.raw", 512, 512),
}


def _load(name):
    blob_p, raw_p, w, h = FIXTURES[name]
    return blob_p.read_bytes(), np.fromfile(raw_p, dtype="<u2"), w, h


def _smooth(rng, h, w, axis=1):
    img = rng.standard_normal((h, w)).cumsum(axis=axis) * 9 + 700
    return img.clip(0, 4095).astype(np.uint16)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_decode_matches_raw_and_host(name):
    blob, raw, w, h = _load(name)
    ((out, ow, oh),) = micw_decode_many([blob], CPU)
    assert (ow, oh) == (w, h)
    assert out.dtype == np.uint16
    assert np.array_equal(out, raw)
    host, hw, hh = ref_st.micw_decompress_host(blob)
    assert (hw, hh) == (w, h) and np.array_equal(out, host)


@pytest.mark.parametrize("pred", ["zzd", "vdd"])
def test_small_alias_blobs(pred):
    """Alias zzd / vdd containers made here by mic_tpu's encoder, with a
    constant strip and a raw (incompressible) strip riding along."""
    rng = np.random.default_rng(7)
    h, w = 48, 256
    px = _smooth(rng, h, w, axis=1 if pred == "zzd" else 0)
    px[16:32] = 1234  # constant strip
    px[32:] = rng.integers(0, 65535, (16, w))  # raw strip
    px = px.ravel()
    blob = ref_st.micw_compress(px, w, h, int(px.max()), num_strips=3,
                                predictor=pred, entropy="alias")
    modes = [s[5] for s in ref_st.micw_parse(blob)[7]]
    assert modes == [ref_st._PRED_MODE[pred], ref_st.STRIP_MODE_CONST, ref_st.STRIP_MODE_RAW]
    ((out, ow, oh),) = micw_decode_many([blob], CPU)
    assert (ow, oh) == (w, h) and np.array_equal(out, px)


def test_plan_matches_mic_tpu_plan():
    """A tiny two-image batch (FF 57 and FF 41): every bucket of the
    port's plan equals mic_tpu's MicwDecodePlan bucket, whole array."""
    rng = np.random.default_rng(8)
    h, w = 16, 256
    imgs = [_smooth(rng, h, w).ravel(), _smooth(rng, h, w, axis=0).ravel()]
    blobs = [ref_st.micw_compress(imgs[0], w, h, int(imgs[0].max()), num_strips=2),
             ref_st.micw_compress(imgs[1], w, h, int(imgs[1].max()), num_strips=2,
                                  entropy="alias")]
    want = ref_st.MicwDecodePlan(blobs).run()
    plan = MicwDecodePlan(blobs, CPU)
    got = plan.run()
    assert set(got) == set(want) and len(got) >= 2
    for k in want:
        assert np.array_equal(got[k].numpy().view(np.uint16), np.asarray(want[k])), k
    for (out, _w, _h), px in zip(plan.assemble(got), imgs):
        assert np.array_equal(out, px)


def test_verify_counts_mismatches():
    ct, ct_raw, _, _ = _load("CT_dev")
    mr, mr_raw, _, _ = _load("MR_dev_alias")
    wb, wb_raw, _, _ = _load("wide_banded")
    blobs, raws = [ct, mr, wb, ct], [ct_raw, mr_raw, wb_raw, ct_raw]
    plan = MicwDecodePlan(blobs, CPU)
    decoded = plan.run()
    assert plan.verify_batch(decoded, raws) == 0
    bad = wb_raw.copy()
    bad[[5, 70000]] ^= 1
    assert plan.verify_batch(decoded, [ct_raw, mr_raw, bad, ct_raw]) == 2
    assert plan.verify_against(decoded, bad, 2) == 2
    assert plan.verify_against(decoded, ct_raw, 3) == 0
    for (out, _w, _h), raw in zip(plan.assemble(decoded), raws):
        assert np.array_equal(out, raw)


def _blob(pred, w, h, lanes=128):
    rng = np.random.default_rng(9)
    px = _smooth(rng, h, w).ravel()
    return ref_st.micw_compress(px, w, h, int(px.max()), num_strips=1,
                                predictor=pred, lanes=lanes), px


@pytest.mark.parametrize("case", ["avg_fixture", "zzr", "width_192", "vdd_width_384", "lanes_64"])
def test_out_of_slice_raises(case):
    """Strips once outside the port's slice: the avg fixture, zzr and zzd
    at width 192 and vdd at 384 take the post path, a 64-lane container
    the scan tier; each decodes bit-exact against the pixels and
    micw_decompress_host."""
    blob, px = {
        "avg_fixture": lambda: ((TESTDATA / "MR_dev_auto.micw").read_bytes(),
                                np.fromfile(TESTDATA / "MR_dev_auto.raw", dtype="<u2")),
        "zzr": lambda: _blob("zzr", 192, 16),
        "width_192": lambda: _blob("zzd", 192, 16),
        "vdd_width_384": lambda: _blob("vdd", 384, 16),
        "lanes_64": lambda: _blob("zzd", 256, 16, lanes=64),
    }[case]()
    plan = MicwDecodePlan([blob], CPU)
    kind = ("scan", 64) if case == "lanes_64" else ("post",)
    assert all(k[:len(kind)] == kind for k in plan.buckets), list(plan.buckets)
    ((out, w, h),) = plan.assemble(plan.run())
    assert np.array_equal(out, px)
    host, hw, hh = ref_st.micw_decompress_host(blob)
    assert (hw, hh) == (w, h) and np.array_equal(out, np.asarray(host).ravel())


def test_out_of_slice_tables_raise():
    """FF 41 with tableLog > 12 keys a scan bucket, as in mic_tpu; FF 57
    beyond the packed kernel's tableLog 12 / alphabet 4096 keys a
    two-table post bucket (hand-made parses: the encoders never write
    them; real containers decode in tests/test_torch_post_decode.py and
    tests/test_torch_scan_decode.py)."""
    blob, _raw, _w, _h = _load("MR_dev")
    p = mict_parse(ref_st.micw_parse(blob)[7][0][0])
    alias = (1, np.zeros(0, np.uint16))
    wide = np.ones(5000, np.int64)
    entry = (b"", 0, 0, 0, 0, st.STRIP_MODE_ZZD)
    key = st._strip_bucket((128, 13, *p[2:7], alias), entry, "zzd", 256, 16, False)
    assert key == ("scan", 128, st._pow2_at_least(-(-p[2] // 128), 8), "zzd", 256, 16, 0, 0)
    for bogus in ((128, 13, *p[2:7], None), (128, 12, *p[2:5], wide, 5000, None)):
        key = st._strip_bucket(bogus, entry, "zzd", 256, 16, False)
        assert key[:3] == ("post", "two_table", "zzd"), key
