"""The port's jax-free copies of mic_tpu's decode-side host code, pinned
to the originals array for array: MICW / MICT parsing, the slot and
alias tables, and the two kernel-operand builders, on every in-repo MICW
fixture.  Also: importing the port pulls in no jax, and the jax-free
alias fixture the GPU run decodes is exactly what mic_tpu's encoder
writes."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from mic_tpu.tpu import device_rans as ref_dr  # noqa: E402
from mic_tpu.tpu import pallas_rans as ref_pr  # noqa: E402
from mic_tpu.tpu import strips as ref_st  # noqa: E402
from mic_tpu_torch.tpu import device_rans as dr  # noqa: E402
from mic_tpu_torch.tpu import rans_decode as rd  # noqa: E402
from mic_tpu_torch.tpu import strips as st  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = sorted((ROOT / "web" / "testdata").glob("*.micw")) + [
    ROOT / "tests" / "data" / "torch_port" / "CT_dev_alias.micw"
]


def _assert_same(a, b, where=""):
    """Deep equality of nested tuples / dicts / numpy arrays / scalars."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


def _entropy_strips(blob):
    parsed = ref_st.micw_parse(blob)
    return [s for s in parsed[7] if ref_st.strip_predictor(parsed[5], s[5]) is not None]


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.name)
def test_container_and_stream_parse(path):
    blob = path.read_bytes()
    _assert_same(st.micw_parse(blob), ref_st.micw_parse(blob), "micw_parse")
    assert st.micw_band_info(blob) == ref_st.micw_band_info(blob)
    for i, s in enumerate(_entropy_strips(blob)):
        _assert_same(dr.mict_parse(s[0]), ref_dr.mict_parse(s[0]), f"strip {i}")


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.name)
def test_tables_and_operand_builders(path):
    parsed = [ref_dr.mict_parse(s[0]) for s in _entropy_strips(path.read_bytes())]
    std = [p for p in parsed if p[7] is None]
    ali = [p for p in parsed if p[7] is not None]
    for p in parsed:
        norm, tl, alias = p[5], p[1], p[7] is not None
        _assert_same(dr.slot_tables(norm, tl, alias), ref_dr.slot_tables(norm, tl, alias))
        if alias:
            _assert_same(dr.alias_construct(norm, tl), ref_dr.alias_construct(norm, tl))
    for min_steps in (0, 1024):
        if std:
            tl = max(max(p[1] for p in std), 7)
            _assert_same(rd.build_packed_tables(std, tl, min_steps),
                         ref_pr.build_packed_tables(std, tl, min_steps))
        if ali:
            _assert_same(rd.build_alias_bucket_tables(ali, min_steps),
                         ref_pr.build_alias_bucket_tables(ali, min_steps))


def test_alias_construct_wide_alphabets():
    """Alphabets in (128, 256] exhaust the large stack and pair two small
    symbols; beyond 256 the layout is infeasible on both sides."""
    rng = np.random.default_rng(4)
    for alpha in (60, 200, 250):
        data = rng.integers(0, alpha, 20000).astype(np.uint16)
        p = ref_dr.mict_parse(ref_dr.mict_encode_alias(data, table_log=12))
        _assert_same(dr.alias_construct(p[5], p[1]), ref_dr.alias_construct(p[5], p[1]))
        _assert_same(dr.alias_slot_tables(p[5], p[1]), ref_dr.alias_slot_tables(p[5], p[1]))
    norm = np.ones(300, np.int64)
    norm[0] += (1 << 10) - 300
    with pytest.raises(ref_dr.AliasInfeasible):
        ref_dr.alias_construct(norm, 10)
    with pytest.raises(dr.AliasInfeasible):
        dr.alias_construct(norm, 10)


def test_band_and_predictor_helpers():
    px = np.fromfile(ROOT / "web" / "testdata" / "wide_banded.raw", dtype="<u2")
    split = st.band_split(px, 1024, 512)
    _assert_same(split, ref_st.band_split(px, 1024, 512))
    assert np.array_equal(st.band_merge(split[0], 512, 1024, 512), px)
    for gpred in ("zz", "zzd", "avg"):
        for mode in range(11):
            assert st.strip_predictor(gpred, mode) == ref_st.strip_predictor(gpred, mode)


def test_import_pulls_in_no_jax():
    code = ("import sys, mic_tpu_torch, mic_tpu_torch.tpu.rans_encode; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mic_tpu.tpu'))]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_alias_fixture_is_reproducible():
    """tests/data/torch_port/CT_dev_alias.micw was written by

        px = np.fromfile("web/testdata/CT_dev.raw", dtype="<u2")
        micw_compress(px, 512, 512, int(px.max()), entropy="alias")

    (mic_tpu.tpu.strips); the GPU run decodes it without jax."""
    px = np.fromfile(ROOT / "web" / "testdata" / "CT_dev.raw", dtype="<u2")
    blob = ref_st.micw_compress(px, 512, 512, int(px.max()), entropy="alias")
    assert blob == (ROOT / "tests" / "data" / "torch_port" / "CT_dev_alias.micw").read_bytes()
    modes = sorted(s[5] for s in ref_st.micw_parse(blob)[7])
    assert modes == [ref_st.STRIP_MODE_ZZD, ref_st.STRIP_MODE_VDD,
                     ref_st.STRIP_MODE_PDD, ref_st.STRIP_MODE_PDD]
