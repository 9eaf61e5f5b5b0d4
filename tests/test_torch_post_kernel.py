"""The post kernel, ``csrc/post.cu``, and its wrappers in ``tpu/post.py``.

* :func:`post.post_decode_groups` / :func:`post.post_decode` on CPU
  tensors equal :func:`post.post_batch` (which they call), count no
  launch, and raise ValueError on an operand the kernel does not take;
* :class:`post.PostPacking`'s descriptors, blocks, parts and sizes for a
  mixed batch of the post path's kinds (phase 6 of ``chip_smoke.py`` in
  small: the avg fixture, escaped zz in both entropy families, escaped
  avg, direct modes at a width that is not a multiple of 128, r-modes,
  a scan bucket);
* the plan's post stage on the CPU, bucket by bucket, against
  ``mic_tpu``'s ``_micw_post_batch`` on the same symbols;
* ``csrc/post.cu`` itself, built by the host C++ compiler against
  ``tests/cuda_emu/cuda_runtime.h`` (a block as 256 threads with real
  barriers and warp exchanges) and run against ``post_batch`` on those
  buckets, clean and with damaged symbols, and on seeded random operands
  and table entries (damaged streams of every kind);
* the reference formats' route ``avg_i`` (interleaved RLE, its run
  headers found on the card): the twin against the host decode on the
  PICS writers' strips at 2, 4 and 8 states, its packing, its checks, and
  the kernel's interleaved instance emulated against the twin on those
  strips, damaged ones, seeded random streams and a strip of more runs
  than shared memory holds;
* the ``cuda`` tests: the kernel on the card against ``post_batch`` on
  every post bucket of the fixtures, clean and damaged, one launch a
  call; the interleaved instance on the ``avg_i`` cases above.

Tolerance 0: a lossless codec.  The module needs no jax at import (the
``ref`` fixture imports it), so the ``cuda`` test runs on a machine with
a GPU and no jax:
``python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_post_kernel.py``.
"""

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mic_tpu_torch import _build
from mic_tpu_torch.tpu import post
from mic_tpu_torch.tpu import rans_decode as rd
from mic_tpu_torch.tpu import scan_decode as sd
from mic_tpu_torch.tpu import strips as st

ROOT = Path(__file__).resolve().parent.parent
TESTDATA = ROOT / "web" / "testdata"
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref():
    """mic_tpu's post program (needs jax)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from mic_tpu.tpu import strips

    return SimpleNamespace(jnp=jnp, st=strips)


def _blobs():
    """Phase 6's kinds in small: the avg fixture x2 (two 256 x 128 strips
    each), CT_dev at tl 13 (the two-table front end: zzd, vdd and pdd
    strips of 512 x 128), then crops of CT_dev encoded by the port's host encoder: escaped zz
    standard and alias and escaped avg (160 x 96, the top left corner: noisier
    crops of these sizes are stored raw), zzd and vdd at width 200
    and zzr and pdr at width 100 (not multiples of 128), zz at 32 lanes (a
    scan bucket)."""
    ct = np.fromfile(TESTDATA / "CT_dev.raw", dtype="<u2").reshape(512, 512)

    def crop(y, x, h, w, pred, ent="standard", strips=1, lanes=128):
        c = np.ascontiguousarray(ct[y:y + h, x:x + w])
        return st.micw_compress(c.ravel(), w, h, int(c.max()), num_strips=strips,
                                predictor=pred, entropy=ent, lanes=lanes)

    mr = (TESTDATA / "MR_dev_auto.micw").read_bytes()
    return [mr, mr, (ROOT / "tests" / "data" / "torch_port" / "CT_dev_tl13.micw").read_bytes(),
            crop(0, 0, 96, 160, "zz", strips=3), crop(0, 0, 96, 160, "zz", "alias", strips=3),
            crop(0, 0, 96, 160, "avg", strips=3), crop(260, 150, 16, 200, "zzd"),
            crop(260, 150, 16, 200, "vdd"), crop(300, 200, 24, 100, "zzr"),
            crop(300, 200, 24, 100, "pdr"), crop(300, 150, 96, 130, "zz", strips=2, lanes=32)]


@pytest.fixture(scope="module")
def mixed():
    """A CPU plan over :func:`_blobs` and its post groups [(ent, meta, kw)]
    on the entropy twins' symbols."""
    plan = st.MicwDecodePlan(_blobs(), CPU)
    outs = dict(zip(plan._direct_keys, rd.rans_decode_direct_groups(plan._direct_groups)))
    outs.update(zip(plan._scan_keys, sd.rans_decode_lanes_groups(plan._scan_groups)))
    groups = [(outs[k], *g) for k, g in zip(plan._post_keys, plan._post_groups)]
    return plan, groups


def _twin(groups):
    return [post.post_batch(e, m[:, 0], m[:, 1], m[:, 2], **kw) for e, m, kw in groups]


def _flipped(groups, n, seed):
    """``groups`` with ``n`` symbols of each entropy output XORed with a
    random nonzero word."""
    rng = np.random.default_rng(seed)
    out = []
    for e, m, kw in groups:
        bad = e.clone()
        flat = bad.view(-1)
        at = torch.from_numpy(rng.integers(0, flat.numel(), n)).to(flat.device)
        word = torch.from_numpy(rng.integers(1, 1 << 16, n).astype(np.uint16).view(np.int16))
        flat[at] ^= word.to(flat.device)
        out.append((bad, m, kw))
    return out


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------


def test_cpu_wrappers_take_post_batch_and_count_no_launch(mixed, monkeypatch):
    plan, groups = mixed

    def no_library(*_a, **_k):
        raise AssertionError("the CPU path must not build or load the kernel library")

    monkeypatch.setattr(_build, "kernel_library", no_library)
    launches, calls = post.post_decode_groups.launches, post.post_batch.calls
    got = post.post_decode_groups(groups, plan.post_packing)
    assert post.post_batch.calls - calls == len(groups)
    want = _twin(groups)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for (e, m, kw), w in zip(groups, want):
        assert torch.equal(post.post_decode(e, m, **kw), w)
    assert post.post_decode_groups.launches == launches
    assert post.post_decode_groups([]) == []


def test_plan_runs_post_stage_through_the_groups_wrapper(mixed):
    """``MicwDecodePlan.run`` hands every post bucket to one
    ``post_decode_groups`` call (``post_batch`` once a bucket on the CPU),
    and a bucket alone takes ``post_decode``."""
    plan, groups = mixed
    kinds = {kw["predictor"] for _e, _m, kw in groups}
    assert kinds == {"avg", "zz", "zzd", "vdd", "pdd", "zzr", "pdr"}
    assert any(k[0] == "scan" for k in plan._post_keys)
    calls = post.post_batch.calls
    decoded = plan.run()
    assert post.post_batch.calls - calls == len(plan._post_keys)
    for k, w in zip(plan._post_keys, _twin(groups)):
        assert torch.equal(decoded[k], w)
        assert torch.equal(plan.buckets[k](), w)
    want = [st.micw_decompress_host(b)[0] for b in plan.blobs]
    assert plan.verify_batch(decoded, want) == 0


def _bad_operand(groups, fault):
    """``groups``' first bucket with one operand made wrong."""
    (e, m, kw), rest = groups[0], groups[1:]
    if fault == "dtype":
        e = e.to(torch.int32)
    elif fault == "rows":
        e = e[1:]
    elif fault == "non_contiguous":
        e = e.reshape(e.shape[0], -1)[:, ::2]
    elif fault == "predictor":
        kw = dict(kw, predictor="med")
    elif fault == "missing_argument":
        kw = {k: v for k, v in kw.items() if k != "delim"}
    elif fault == "max_tokens":
        kw = dict(kw, max_tokens=1)
    elif fault == "meta_dtype":
        m = m.to(torch.int32)
    elif fault == "meta_shape":
        m = m[:, :2].contiguous()
    return [(e, m, kw)] + rest


@pytest.mark.parametrize("fault", ["dtype", "rows", "non_contiguous", "predictor",
                                   "missing_argument", "max_tokens", "meta_dtype", "meta_shape"])
def test_bad_operands_raise(mixed, fault):
    _plan, groups = mixed
    avg = [g for g in groups if g[2]["predictor"] == "avg"]
    bad = _bad_operand(avg, fault)
    with pytest.raises(ValueError):
        post.post_decode_groups(bad)
    e, m, kw = bad[0]
    with pytest.raises(ValueError):
        post.post_decode(e, m, **kw)


def test_packing_for_other_groups_raises(mixed):
    plan, groups = mixed
    with pytest.raises(ValueError, match="other groups"):
        post.post_decode_groups(groups[1:], plan.post_packing)
    e, m, kw = groups[0]
    with pytest.raises(ValueError, match="other groups"):
        post.post_decode_groups([(e, m.clone(), kw)] + groups[1:], plan.post_packing)


def test_avg_ring_past_a_block_raises():
    """The avg inverse takes bands of 256 rows, so no strip height outgrows
    a block's shared memory (the first form's ring of 8 bytes a row
    refused strips past 27,008 rows); a strip of 2^31 pixels or more is
    past the kernel's range and raises."""
    meta = torch.zeros((1, 3), dtype=torch.int64)
    kw = dict(width=4, strip_h=27009, max_runs=128, max_tokens=128, mid_count=127, delim=255,
              predictor="avg")
    pk = post.PostPacking([(meta, kw)], CPU)
    assert pk.flags_total == -(-4 * 27009 // 32)
    with pytest.raises(ValueError, match="range"):
        post.PostPacking([(meta, dict(kw, strip_h=1 << 29))], CPU)


def test_module_imports_and_runs_without_nvcc():
    """``tpu/post.py`` (the wrapper of ``csrc/post.cu``) imports, packs and
    runs its CPU path in a fresh interpreter with no nvcc and no CUDA
    toolkit in sight, and builds no kernel library."""
    code = ("import torch, mic_tpu_torch._build as b; from mic_tpu_torch.tpu import post; "
            "m = torch.zeros((1, 3), dtype=torch.int64); "
            "kw = dict(width=4, strip_h=2, max_runs=128, max_tokens=128, mid_count=0, "
            "delim=0, predictor='zzd'); "
            "(o,) = post.post_decode_groups([(torch.ones((1, 128), dtype=torch.int16), m, kw)]); "
            "assert o.shape == (1, 8) and post.post_decode_groups.launches == 0; "
            "print(b.kernel_library.cache_info().currsize)")
    env = {**os.environ, "PATH": "/usr/bin:/bin",
           "CUDA_HOME": str(ROOT / "build" / "no-such-cuda")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode == 0 and res.stdout.strip() == "0", res.stdout + res.stderr


# ---------------------------------------------------------------------------
# the packing
# ---------------------------------------------------------------------------


def test_packing_descriptors_for_a_mixed_batch(mixed):
    plan, groups = mixed
    pk = plan.post_packing
    assert len(pk.desc) == len(groups) and pk.rows == [m.shape[0] for _e, m, _k in groups]
    out = runs = flags = 0
    for d, (_e, m, kw), key in zip(pk.desc, groups, plan._post_keys):
        S, pred = m.shape[0], kw["predictor"]
        need = kw["width"] * kw["strip_h"]
        assert plan.buckets[key].post == kw and (key[2] if key[0] == "post" else key[3]) == pred
        assert (int(d["out_off"]), int(d["runs_off"]), int(d["flags_off"])) == (out, runs, flags)
        assert [int(d[f]) for f in ("width", "strip_h", "max_runs", "max_tokens", "mid",
                                    "delim")] == [kw[k] for k in post._KWARGS[:-1]]
        assert post.PREDICTORS[int(d["pred"])] == pred and int(d["meta"]) == 0  # on the CPU
        out += S * need
        runs += 0 if pred in ("zzd", "vdd", "pdd") else S * kw["max_runs"]
        flags += S * -(-need // 32) if pred in ("zz", "avg") else 0  # a bit a pixel, in words
    assert (pk.out_total, pk.runs_total, pk.flags_total) == (out, runs, flags)
    assert [m.shape[0] for _e, m, kw in groups if kw["width"] == 256] == [4]  # x2 replicas
    # a block a strip, each once; avg strips first, then zz, then the rest
    assert pk.parts == [(0, len(groups), 0, sum(pk.rows))]
    assert sorted(map(tuple, pk.blocks.tolist())) == [(g, s) for g, S in enumerate(pk.rows)
                                                      for s in range(S)]
    order = [post._COST.get(groups[g][2]["predictor"], 2) for g in pk.blocks[:, 0]]
    assert order == sorted(order) and order[0] == 0


def test_packing_splits_launches_past_max_groups():
    """More than ``MAX_GROUPS`` buckets: a launch a ``MAX_GROUPS``, group
    numbers counted from the launch's first."""
    kw = dict(width=3, strip_h=2, max_runs=128, max_tokens=128, mid_count=0, delim=0,
              predictor="zzd")
    n = post.MAX_GROUPS + 3
    metas = [torch.zeros((1 + g % 2, 3), dtype=torch.int64) for g in range(n)]
    pk = post.PostPacking([(m, kw) for m in metas], CPU)
    rows = [1 + g % 2 for g in range(n)]
    first = sum(rows[:post.MAX_GROUPS])
    assert pk.parts == [(0, post.MAX_GROUPS, 0, first), (post.MAX_GROUPS, n, first, sum(rows))]
    assert pk.blocks[first:, 0].tolist() == [0, 1, 1, 2]
    assert pk.runs_total == pk.flags_total == 0


# ---------------------------------------------------------------------------
# against mic_tpu
# ---------------------------------------------------------------------------


def test_plan_post_buckets_match_mic_tpu(ref, mixed):
    """Each post bucket's CPU output equals ``mic_tpu``'s
    ``_micw_post_batch`` on the same symbols (padded to the strip for the
    direct modes, as ``mic_tpu``'s plan pads them)."""
    _plan, groups = mixed
    got = post.post_decode_groups(groups)
    for (e, m, kw), g in zip(groups, got):
        syms = e.reshape(e.shape[0], -1).numpy().view(np.uint16)
        need = kw["width"] * kw["strip_h"]
        if kw["predictor"] in ("zzd", "vdd", "pdd") and syms.shape[1] < need:
            syms = np.pad(syms, ((0, 0), (0, need - syms.shape[1])))
        n_tok, n_runs, n_same = (ref.jnp.asarray(m[:, i].numpy().astype(np.int32))
                                 for i in range(3))
        want = np.asarray(ref.st._micw_post_batch(ref.jnp.asarray(syms), n_tok, n_runs, n_same,
                                                  **kw))
        assert np.array_equal(g.numpy().view(np.uint16), want.reshape(g.shape)), kw


# ---------------------------------------------------------------------------
# csrc/post.cu on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``csrc/post.cu`` built by the host compiler against the CPU stand-in
    of ``tests/cuda_emu``; its ``mic_post_groups`` entry point, declared."""
    src = (ROOT / "mic_tpu_torch" / "csrc" / "post.cu").read_text()
    src, n_launch = re.subn(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), [^>]+>>>\(",
                            r"emu_launch(\1, \2, \3, \4, ", src)
    assert n_launch == 1 and "extern __shared__" not in src  # the kernel's shared memory is static
    tmp = tmp_path_factory.mktemp("post_emu")
    (tmp / "post_emu.cpp").write_text(src)
    lib_path = tmp / "libpost_emu.so"
    cmd = [_build.host_compiler(), "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
           "-Wno-unknown-pragmas", f"-I{ROOT / 'tests' / 'cuda_emu'}", "-o", str(lib_path),
           str(tmp / "post_emu.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    lib = ctypes.CDLL(str(lib_path))
    for name in ("mic_post_groups", "mic_post_groups_interleaved"):
        getattr(lib, name).argtypes = _build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _emulated_groups(lib, groups):
    """``groups`` through the emulated kernel, laid out by
    ``PostPacking`` as the card's launch is, a part with an ``avg_i``
    bucket through the interleaved instance."""
    pk = post.PostPacking([(m, kw) for _e, m, kw in groups], CPU)
    desc = pk.desc.copy()
    desc["meta"] = [m.data_ptr() for m in pk.metas]
    blocks = np.ascontiguousarray(pk.blocks)
    ents = [e.contiguous().view(e.shape[0], -1) for e, _m, _kw in groups]
    out = np.zeros(pk.out_total, np.int16)
    runs = np.full(16 * pk.runs_total + 16, 0xA5, np.uint8)  # garbage, as on the card
    flags = np.full(pk.flags_total + 4, 0xA5A5A5A5, np.uint32)
    busy = np.zeros(pk.slots, np.int32)
    ptrs = np.array([e.data_ptr() for e in ents], np.uint64)
    cols = np.array([e.shape[1] for e in ents], np.int32)
    for (g0, g1, b0, b1), inter in zip(pk.parts, pk.interleaved):
        args = (desc.ctypes.data + g0 * desc.itemsize, blocks.ctypes.data + b0 * 8, b1 - b0,
                ptrs.ctypes.data + 8 * g0, cols.ctypes.data + 4 * g0, g1 - g0,
                out.ctypes.data, runs.ctypes.data, flags.ctypes.data)
        if inter:
            rc = lib.mic_post_groups_interleaved(*args, busy.ctypes.data, pk.slots, None)
        else:
            rc = lib.mic_post_groups(*args, None)
        assert rc == 0
    assert not busy.any()  # every runs-scratch slot freed
    res, off = [], 0
    for S, kw in zip(pk.rows, pk.kws):
        need = kw["width"] * kw["strip_h"]
        res.append(torch.from_numpy(out[off:off + S * need].reshape(S, need).copy()))
        off += S * need
    return res


@pytest.mark.parametrize("flips", [0, 50])
def test_post_cu_emulated_matches_post_batch(emulated, mixed, flips):
    """Every post bucket of :func:`_blobs` of strips up to 16,384 pixels
    (the larger fixtures' strips take seconds: a block's barriers are slow
    on the CPU; the CT crops and the random cases stand in for them)."""
    _plan, groups = mixed
    groups = [g for g in groups if g[2]["width"] * g[2]["strip_h"] <= 16384]
    if flips:
        groups = _flipped(groups, flips, flips)
    for (_e, _m, kw), g, w in zip(groups, _emulated_groups(emulated, groups), _twin(groups)):
        assert torch.equal(g, w), (kw, int((g != w).sum()))


def _random_group(rng):
    """A bucket of seeded random symbols, table entries and static
    arguments: honest and damaged streams of every kind alike."""
    pred = post.PREDICTORS[rng.integers(0, len(post.PREDICTORS))]
    w = int(rng.choice([1, 5, 33, 64, 100]))
    h = int(rng.choice([1, 2, 7, 300] if pred == "avg" else [1, 3, 17, 40]))
    S, C = int(rng.integers(1, 3)), int(rng.choice([128, 256, 1024]))
    delim = int(rng.choice([1, 4, 2047, 65535, 70000]))
    syms = np.where(rng.random((S, C)) < 0.3, rng.integers(0, 1 << 16, (S, C)),
                    rng.integers(0, int(rng.choice([5, 40])), (S, C)))
    if rng.random() < 0.5:
        syms = np.where(rng.random((S, C)) < 0.2, delim & 0xFFFF, syms)
    max_runs = int(rng.choice([1, 128, 2048]))
    max_tokens = int(rng.choice([2, 128, w * h + 7, 2 * w * h + 300]))
    meta = np.stack([rng.integers(-5, 3 * max_tokens + 10, S),
                     rng.integers(-5, 2 * max_runs + 10, S),
                     rng.integers(-3, C + 10, S)], axis=1).astype(np.int64)
    if rng.random() < 0.2:
        meta[:, 1] = rng.integers(0, 1 << 32, S)
    kw = dict(width=w, strip_h=h, max_runs=max_runs, max_tokens=max_tokens,
              mid_count=int(rng.choice([0, 3, 127, 16383])), delim=delim, predictor=pred)
    return (torch.from_numpy(syms.astype(np.uint16).view(np.int16).copy()),
            torch.from_numpy(meta), kw)


@pytest.mark.parametrize("seed", range(3))
def test_post_cu_emulated_random_operands(emulated, seed):
    rng = np.random.default_rng(1900 + seed)
    groups = [_random_group(rng) for _ in range(8)]
    for (_e, _m, kw), g, w in zip(groups, _emulated_groups(emulated, groups), _twin(groups)):
        assert torch.equal(g, w), (kw, int((g != w).sum()))


# The kernel's parse takes CHUNK positions of tokens[1:] at a time (8 words
# of 32 a warp, 8 warps), its expand stages RUNS_SMEM runs in shared memory
# (post.cu: kChunk, kRunsSmem); the cases below put their edges there.
CHUNK, RUNS_SMEM = 2048, 1024
_MID, _DELIM = 127, 4095


def _soa_symbols(tokens, segments, rng):
    """The SoA-RLE stream of ``tokens`` cut into ``segments``: ("same", n[,
    value]) a same-run (n <= _MID tokens, all equal; n may be 0, then with
    its value given), ("lit", n) a literal run.  Returns (symbols padded to
    a multiple of 128 with noise, n_runs, n_same, n_tokens)."""
    counts, values, lits, at = [], [], [], 0
    for kind, n, *val in segments:
        if kind == "same":
            v = int(tokens[at]) if n else val[0]
            assert n <= _MID and all(int(x) == v for x in tokens[at:at + n])
            counts.append(n)
            values.append(v)
        else:
            assert n > 0
            counts.append(_MID + n)
            lits += [int(x) for x in tokens[at:at + n]]
        at += n
    assert at == len(tokens)
    syms = counts + values + lits
    pad = -len(syms) % 128 + 128
    return (np.array(syms + rng.integers(0, 1 << 16, pad).tolist(), np.uint16), len(counts),
            len(values), at)


def _lits(n, step=100):
    return [("lit", min(step, n - a)) for a in range(0, n, step)]


def _edge_case(case, rng):
    """(tokens, segments, width, strip_h) of a chunk-edge case: token 0 is
    the strip's maxValue word, tokens[1:] the escaped stream."""
    w, h = 64, 64
    if case == "many_runs":  # past RUNS_SMEM runs: the runs in device scratch
        segs, n = [], 0
        while len(segs) < RUNS_SMEM + 300:
            segs.append(("same", int(rng.integers(1, 4))) if len(segs) % 2
                        else ("lit", int(rng.integers(1, 3))))
            n += segs[-1][1]
        body = rng.integers(0, 4000, n)
        at = 0
        for kind, k in segs:  # a same-run's tokens equal, one a delim now and then
            if kind == "same":
                body[at:at + k] = _DELIM if rng.random() < 0.2 else body[at]
            at += k
        return body, segs, w, h
    n = {"delim_run_straddles": 4400, "same_run_straddles": 4400, "zero_length_runs": 4400,
         "need_mid_chunk": 5000, "fewer_starts": 2500, "marker_at_the_end": CHUNK + 2}[case]
    body = rng.integers(0, 4000, n)  # tokens[0:] with token 0 the maxValue word
    if case == "delim_run_straddles":  # odd and even delim runs across chunk, warp, word edges
        for a, b in ((2044, 2054), (4094, 4101), (251, 260), (2079, 2082)):
            body[a:b] = _DELIM
        return body, _lits(n), 256, 16  # rows of two 128-pixel rounds of the row scan
    if case == "same_run_straddles":  # delim and value same-runs across the chunk edges
        body[2031:2071] = _DELIM
        body[4091:4102] = 7
        segs = _lits(2031) + [("same", 40)] + _lits(4091 - 2071) + [("same", 11)]
        return body, segs + _lits(n - 4102), 200, 20  # a round and a part a row
    if case == "zero_length_runs":  # zero-length runs where tokens[1:] crosses CHUNK
        segs = ([("same", 0, 9)] + _lits(CHUNK + 1) + [("same", 0, 5), ("same", 0, _DELIM)]
                + _lits(n - CHUNK - 1) + [("same", 0, 3)])
        body[CHUNK - 2:CHUNK + 1] = _DELIM
        return body, segs, w, h
    if case == "need_mid_chunk":  # tokens past the strip's pixels: the parse stops mid-chunk
        body[2995:3003] = _DELIM
        return body, _lits(n), 60, 50
    if case == "marker_at_the_end":  # tokens[1:]'s last, at CHUNK, a marker: its pixel itself
        body[-1] = _DELIM
        return body, _lits(n), w, h
    assert case == "fewer_starts"  # fewer token starts than pixels, position 0 a marker
    body[1] = _DELIM
    body[2040:2050] = _DELIM
    return body, _lits(n), w, h


@pytest.mark.parametrize("case", ["delim_run_straddles", "same_run_straddles",
                                  "zero_length_runs", "need_mid_chunk", "fewer_starts",
                                  "marker_at_the_end", "many_runs"])
def test_post_cu_emulated_chunk_edges(emulated, case):
    """Streams whose delim runs, literal and same-runs, zero-length runs,
    last needed token, last token or runs cross the kernel's chunk edges,
    in zz and avg strips (and zzr for ``many_runs``), emulated against
    ``post_batch``."""
    rng = np.random.default_rng(2000 + len(case))
    body, segs, w, h = _edge_case(case, rng)
    syms, n_runs, n_same, n_tok = _soa_symbols(body, segs, rng)
    meta = torch.tensor([[n_tok, n_runs, n_same]], dtype=torch.int64)
    ent = torch.from_numpy(syms.view(np.int16).copy())[None]
    preds = ("zz", "avg", "zzr") if case == "many_runs" else ("zz", "avg")
    # the stream fills tokens[] to its end where its last token is the case
    max_tokens = n_tok if case == "marker_at_the_end" else 128 * -(-(n_tok + 1) // 128)
    groups = [(ent, meta, dict(width=w, strip_h=h, max_runs=128 * -(-(n_runs + 1) // 128),
                               max_tokens=max_tokens, mid_count=_MID, delim=_DELIM,
                               predictor=p)) for p in preds]
    for (_e, _m, kw), g, want in zip(groups, _emulated_groups(emulated, groups), _twin(groups)):
        assert torch.equal(g, want), (case, kw["predictor"], int((g != want).sum()))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_kernel_matches_post_batch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    plan = st.MicwDecodePlan(_blobs() + [(ROOT / "tests" / "data" / "torch_port"
                                          / "CT_dev_tl13.micw").read_bytes()], dev)
    outs = dict(zip(plan._direct_keys, rd.rans_decode_direct_groups(plan._direct_groups,
                                                                    plan.direct_packing)))
    outs.update(zip(plan._scan_keys, sd.rans_decode_lanes_groups(plan._scan_groups,
                                                                 plan.scan_packing)))
    clean = [(outs[k], *g) for k, g in zip(plan._post_keys, plan._post_groups)]
    for groups in (clean, _flipped(clean, 3, 1), _flipped(clean, 50, 2)):
        launches = post.post_decode_groups.launches
        got = post.post_decode_groups(groups, plan.post_packing)
        torch.cuda.synchronize()
        assert post.post_decode_groups.launches == launches + 1
        for (_e, _m, kw), g, w in zip(groups, got, _twin(groups)):
            assert torch.equal(g, w), kw
    calls = post.post_batch.calls
    decoded = plan.run()
    assert post.post_batch.calls == calls
    assert plan.verify_batch(decoded, [st.micw_decompress_host(b)[0] for b in plan.blobs]) == 0


# ---------------------------------------------------------------------------
# the reference formats' route, avg_i: interleaved RLE found on the card
# ---------------------------------------------------------------------------


def _pics_groups(states=8):
    """The strips of a seeded 100 x 40 image written as PICS by the
    reference writer of ``states`` states, in three strips (the last one
    shorter), each an ``avg_i`` bucket of its symbols (padded with zeros
    to rows of 128 words and one more row).  Returns (the groups, the
    image, the strips)."""
    from mic_tpu_torch.ops.fse_codec import fse_decompress_auto
    from mic_tpu_torch.parallel import strips as ps

    rng = np.random.default_rng(5)
    img = (rng.standard_normal((40, 100)).cumsum(0).cumsum(1) * 5).astype(np.int64)
    px = (img - img.min()).clip(0, 60000).astype(np.uint16).ravel()
    writer = {2: ps.compress_parallel_strips, 4: ps.compress_parallel_strips_4state,
              8: ps.compress_parallel_strips_8state}[states]
    w, _h, _sh, strips = ps.pics_strip_blobs(writer(px, 100, 40, int(px.max()), num_strips=3))
    groups = []
    for _y0, sh, blob in strips:
        syms = fse_decompress_auto(blob)
        cols = 128 * -(-len(syms) // 128) + 128
        row = np.zeros((1, cols), np.uint16)
        row[0, :len(syms)] = syms
        groups.append((torch.from_numpy(row.view(np.int16)),
                       torch.tensor([[len(syms), 0, 0]], dtype=torch.int64),
                       dict(width=w, strip_h=sh, max_runs=post.interleaved_runs(cols),
                            max_tokens=2 * w * sh + 1, mid_count=0, delim=0,
                            predictor="avg_i")))
    return groups, px, strips


def _interleaved_group(rng):
    """A bucket of seeded interleaved RLE streams: an Init word for a
    midCount of 0, 1, 3, 127 or 32767 (or 0 or 1 itself), then same-runs,
    literal runs and stray words, cut at the row's end; symbol counts
    below, at and past the row's; any geometry and max_tokens: honest and
    damaged streams alike."""
    w = int(rng.choice([1, 5, 33, 64, 100]))
    h = int(rng.choice([1, 2, 7, 40]))
    S, C = int(rng.integers(1, 3)), int(rng.choice([2, 3, 128, 256, 1024, 4096]))
    syms = np.empty((S, C), np.int64)
    for s in range(S):
        mid = int(rng.choice([0, 1, 3, 127, 32767]))
        row = [2 * mid + 1 if mid else int(rng.integers(0, 2))]
        while len(row) < C:
            r = rng.random()
            if r < 0.4:
                row += [int(rng.integers(0, mid + 1)), int(rng.integers(0, 1 << 16))]
            elif r < 0.8:
                k = int(rng.integers(1, 12))
                row += [mid + k] + rng.integers(0, 1 << 16, k).tolist()
            else:
                row.append(int(rng.integers(0, 1 << 16)))
        syms[s] = row[:C]
    meta = np.stack([rng.integers(-5, C + 10, S), rng.integers(-5, 10, S),
                     rng.integers(-5, 10, S)], axis=1).astype(np.int64)
    kw = dict(width=w, strip_h=h, max_runs=post.interleaved_runs(C) + int(rng.integers(0, 3)),
              max_tokens=int(rng.choice([2, 128, w * h + 7, 2 * w * h + 300])),
              mid_count=int(rng.choice([0, 127])), delim=int(rng.choice([0, 4095])),
              predictor="avg_i")
    return (torch.from_numpy(syms.astype(np.uint16).view(np.int16).copy()),
            torch.from_numpy(meta), kw)


def _many_runs_group(rows: int = 1):
    """``rows`` strips of 3,000 same-runs of 3: more runs than the kernel's
    shared memory holds, so each strip's block claims a slot of the runs
    scratch."""
    syms = [65535] + [3, 7] * 3000
    row = np.zeros((rows, 6144), np.uint16)
    row[:, :len(syms)] = syms
    return (torch.from_numpy(row.view(np.int16)), torch.tensor([[len(syms), 0, 0]] * rows),
            dict(width=100, strip_h=100, max_runs=post.interleaved_runs(6144), max_tokens=20001,
                 mid_count=0, delim=0, predictor="avg_i"))


@pytest.mark.parametrize("states", [2, 4, 8])
def test_avg_i_twin_decodes_the_reference_writers(states):
    """The twin's route on PICS strips of every state count equals the
    source pixels and the host decode (``delta_rle_decompress``)."""
    from mic_tpu_torch.ops.deltarle import delta_rle_decompress
    from mic_tpu_torch.ops.fse_codec import fse_decompress_auto

    groups, px, strips = _pics_groups(states)
    for (e, m, kw), (y0, sh, blob), got in zip(groups, strips, _twin(groups)):
        want = px[y0 * 100:(y0 + sh) * 100]
        assert np.array_equal(got.numpy().view(np.uint16).ravel(), want)
        assert np.array_equal(delta_rle_decompress(fse_decompress_auto(blob), 100, sh), want)


def test_avg_i_packing_takes_the_interleaved_instance():
    groups, _px, _strips = _pics_groups()
    mixed_in = groups + [_many_runs_group()]
    pk = post.PostPacking([(m, kw) for _e, m, kw in mixed_in], CPU)
    assert pk.interleaved == [True]
    assert [int(d["pred"]) for d in pk.desc] == [post.ROUTES.index("avg_i")] * 4
    assert pk.slots == 1  # the CPU's stand-in runs a block at a time
    assert pk.runs_total == sum(kw["max_runs"] for _e, _m, kw in mixed_in)
    assert pk.flags_total == sum(-(-kw["width"] * kw["strip_h"] // 32) for _e, _m, kw in mixed_in)
    micw = post.PostPacking([(torch.zeros((1, 3), dtype=torch.int64),
                              dict(groups[0][2], predictor="avg"))], CPU)
    assert micw.interleaved == [False]


def test_avg_i_runs_scratch_is_a_slot_a_resident_block():
    """An ``avg_i`` bucket's runs scratch is ``max_runs`` a slot, not a
    strip: five strips on the CPU take one slot, beside an avg bucket of
    MICW's, which takes ``max_runs`` a strip."""
    e, m, kw = _many_runs_group(5)
    avg = (torch.zeros((3, 3), dtype=torch.int64), dict(kw, predictor="avg", max_runs=7))
    pk = post.PostPacking([(m, kw), avg], CPU)
    assert pk.slots == 1 and pk.runs_total == kw["max_runs"] + 3 * 7
    assert [int(d["runs_off"]) for d in pk.desc] == [0, kw["max_runs"]]


@pytest.mark.parametrize("fault", ["max_runs", "one_column"])
def test_avg_i_without_room_for_its_runs_raises(fault):
    e, m, kw = _pics_groups()[0][0]
    if fault == "max_runs":
        kw = dict(kw, max_runs=post.interleaved_runs(e.shape[1]) - 1)
    else:
        e = e[:, :1].contiguous()
    with pytest.raises(ValueError, match="avg_i"):
        post.post_decode_groups([(e, m, kw)])


def test_post_cu_emulated_avg_i(emulated):
    """``csrc/post.cu``'s interleaved instance, emulated, equals the twin
    on the writers' strips (clean and with symbols flipped), on seeded
    random streams (damaged ones of every kind) and on strips of more
    runs than shared memory holds, three in one bucket taking the one slot
    in turn (every slot free after the launch)."""
    groups = _pics_groups()[0] + [_many_runs_group(), _many_runs_group(3)]
    groups += _flipped(groups, 20, 7)
    for seed in range(3):
        rng = np.random.default_rng(4000 + seed)
        groups += [_interleaved_group(rng) for _ in range(4)]
    for (_e, _m, kw), g, w in zip(groups, _emulated_groups(emulated, groups), _twin(groups)):
        assert torch.equal(g, w), (kw, int((g != w).sum()))


@pytest.mark.cuda
def test_cuda_avg_i_matches_post_batch():
    """The interleaved instance on the card equals the twin on the
    writers' strips, clean and damaged, random streams and many runs (a
    bucket of 1,500 such strips, more than the card's slots, so blocks
    wait for one), one launch a call, every slot free after it; MICW's
    buckets in the same call take that instance too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(4100)
    groups = _pics_groups()[0] + [_many_runs_group(), _many_runs_group(1500)]
    groups += _flipped(groups, 20, 7) + [_interleaved_group(rng) for _ in range(12)]
    plan, micw = st.MicwDecodePlan(_blobs(), CPU), None
    outs = dict(zip(plan._direct_keys, rd.rans_decode_direct_groups(plan._direct_groups)))
    outs.update(zip(plan._scan_keys, sd.rans_decode_lanes_groups(plan._scan_groups)))
    micw = [(outs[k], *g) for k, g in zip(plan._post_keys, plan._post_groups)]
    for batch in (groups, groups + micw):
        on_card = [(e.to(dev), m.to(dev), kw) for e, m, kw in batch]
        launches = post.post_decode_groups.launches
        pk = post.PostPacking([(m, kw) for _e, m, kw in on_card], dev)
        got = post.post_decode_groups(on_card, pk)
        torch.cuda.synchronize()
        assert post.post_decode_groups.launches == launches + 1
        assert 1500 > pk.slots > 100 and not pk.busy.any()
        for (_e, _m, kw), g, w in zip(batch, got, _twin(batch)):
            assert torch.equal(g.cpu(), w), kw
