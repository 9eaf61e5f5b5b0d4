#!/usr/bin/env python3
"""Smoke run of mic_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Setup: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit, builds the CUDA kernels from ``mic_tpu_torch/csrc`` and
   prints the build seconds and nvcc's per-kernel resource report.
2. Kernel vs plain: each kernel against its plain PyTorch version on the
   card, whole output arrays, tolerance 0.  Decode: on the operands of
   the main path's buckets (CT_dev x256 = 1024 strips of 512 steps,
   CT_dev_alias x256, MR_dev_alias x512, plus the alias kernel with
   fused=False).  r-mode decode: on every bucket of phase 5's batch, each
   with its own ``dense`` and with the other one.  Post path: the
   symbols-out kernels on every post bucket of phase 6's batch (packed
   tables; two tables at tl 13, whose tables fit in shared memory; the
   alias kernel with fused=False) and the two-table kernel on
   CT_dev_1strip_tl15 x32 (tl 15, tables read from device memory).
   Encode: on the operands of CT_dev x128 under
   ``micw_compress_device_many`` (auto-fast; standard, and alias for the
   FF 41 form): 3 candidates x 4 strips x 128 = 1536 streams of 512
   steps, one image's operands replicated.  tANS decode: on each launch
   group of phase 7's archive batch (N = 2, 4 and 8, FF 84 and FF 08
   tables, tableLogs 10-13 and counts mixed in a launch).  Times from
   CUDA events after a warm-up (the plain tANS version: its one compared
   call).
3. Decode path: ``MicwDecodePlan`` over a mixed batch (CT_dev x256, the
   batch size the reference bench targets, plus MR_dev, MR_dev_alias,
   wide_banded and CT_dev_alias replicated); every strip of every
   replica is verified against the ``.raw`` pixels, and each decode
   wrapper must have launched during the run.  Prints staging seconds,
   decode GB/s over ``plan.run()``, the launch counts and a torch.profiler
   breakdown of one ``plan.run()`` by device kernel.
4. Encode path: ``MicwEncodePlan`` (what ``micw_compress_device_many``
   runs) over each fixture setting, replicated (CT_dev x64 is a 64-slice
   CT series, 32 MiB of pixels); every container must equal its fixture
   byte for byte, and both encode wrappers must have launched during the
   phase.  Prints, per setting and in total, host seconds of candidate
   generation, of the device encode call (host staging + kernel +
   compaction) and of selection, end-to-end MB/s of input pixels and
   launches per family, all from the unprofiled run; the kernel
   milliseconds from a second device-encode call under torch.profiler;
   and the host staging seconds from a third, separate run of the
   staging alone.  The auto-fast containers are then decoded on the card by
   ``MicwDecodePlan`` and verified pixel for pixel.
5. r-mode decode path: ``MicwDecodePlan`` over the tissue fixtures
   (``tests/data/torch_port/tissue_*.micw``: the three planes of
   ``web/testdata/tissue_dev.raw`` under auto-r standard and best, and
   pdr / zzr-alias of the green plane) x64, plus pdr and zzr-alias with
   FLAG_RDENSE cleared x32: 576 images of 512x384, 1728 r-mode strips, a
   WSI tile server decoding a batch of one slide's tiles.  Every strip of
   every replica is verified against the plane's pixels and both r-mode
   wrappers must have launched during the run.  Prints staging seconds,
   decode GB/s over ``plan.run()``, the launch counts and a profiler
   breakdown.  Then the six auto-r settings are encoded on the card by
   ``micw_compress_device_many`` and must equal their fixtures byte for
   byte.
6. Post-path decode: ``MicwDecodePlan`` over the images whose strips the
   fused kernels do not take, ~1250 strips: MR_dev_auto x128 (FF 57 avg,
   what ``predictor="auto"`` writes), CT_dev under ``predictor="zz"``
   standard x64 and alias x64 (escaped zz), wide_banded cropped to 800
   columns x32 and to 640 x32 (auto-fast: widths not a multiple of 128,
   vdd at width/128 = 5), the green plane of tissue_dev cropped to 500 x
   384 x32 (auto-r: r-modes through the torch expand) and CT_dev_tl13 x32
   (FF 57 at tl 13, a foreign writer's larger tables).  All but the
   fixtures are encoded at the start of the phase by the port's own
   encoder on the card.  Every strip of every replica is verified, and
   both symbols-out wrappers and the alias wrapper must have launched
   during the run.  Prints staging seconds, decode GB/s over
   ``plan.run()``, the launch counts and a profiler breakdown that splits
   the entropy kernels from the post path's torch ops.
7. Reference-format decode: ``fse_decompress_device_batch`` over an
   archive batch of the in-repo reference fixtures' entropy streams
   (MR MIC1 payloads at 2, 4 and 8 states and FF 08 x64, CT_pics8 strips
   x32, MR_pics4 and MR_pics8 strips x64, the compressed planes of
   tissue.mic3 and grey.mic3 x16: 1537 kernel streams, ~77 MB of u16
   symbols; and the 7 streams the headers route to the host, once:
   CT_{2s,4s,8s,rans8} at tableLog 16 and CT_pics4's strips 1-3 at 14).
   Every stream is verified against the port's host decoder of its
   distinct blob, the host-routed set must be exactly the headers', and
   the kernel must have launched.  Prints staging seconds, ms per
   ``run()`` and GB/s of symbols over the kernel streams (CUDA events,
   staging excluded), and a profiler line.  Then each entry point of
   ``tpu.ref_decode`` once on fewer replicas against the ``.raw`` pixels
   (MIC3 level 1 against the same call on the CPU), with the host seconds
   of the entropy and post stages, and ``ingest_plan(entropy="device",
   device_encode=True)`` on MR_pics4 x16 + MR_4s x16, whose decode plan
   must give back the pixels.
8. Prints the kernel report as one JSON line (with each kernel's bound:
   the larger of its bytes over 3.35 TB/s and its integer operations over
   67 T/s, the H100 SXM's memory and CUDA-core rates), then, as the last
   line, ``{"ok": true, "device": {...}}``.

Imports neither jax nor anything of mic_tpu.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TESTDATA = ROOT / "web" / "testdata"
PORT_DATA = ROOT / "tests" / "data" / "torch_port"
CT_ALIAS = PORT_DATA / "CT_dev_alias.micw"

# name -> (container, expected pixels, replicas in the main-path batch)
BATCH = {
    "CT_dev": (TESTDATA / "CT_dev.micw", TESTDATA / "CT_dev.raw", 256),
    "MR_dev": (TESTDATA / "MR_dev.micw", TESTDATA / "MR_dev.raw", 32),
    "MR_dev_alias": (TESTDATA / "MR_dev_alias.micw", TESTDATA / "MR_dev_alias.raw", 32),
    "wide_banded": (TESTDATA / "wide_banded.micw", TESTDATA / "wide_banded.raw", 32),
    "CT_dev_alias": (CT_ALIAS, TESTDATA / "CT_dev.raw", 32),
}
# name -> (container, pixels, predictor, entropy, replicas in the encode phase)
ENCODE = {
    "CT_dev": (TESTDATA / "CT_dev.micw", TESTDATA / "CT_dev.raw", "auto-fast", "standard", 64),
    "CT_dev_alias": (CT_ALIAS, TESTDATA / "CT_dev.raw", "auto-fast", "alias", 16),
    "MR_dev": (TESTDATA / "MR_dev.micw", TESTDATA / "MR_dev.raw", "auto-fast", "standard", 16),
    "MR_dev_alias": (TESTDATA / "MR_dev_alias.micw", TESTDATA / "MR_dev_alias.raw",
                     "auto-fast", "alias", 16),
    "MR_dev_rbest": (TESTDATA / "MR_dev_rbest.micw", TESTDATA / "MR_dev_rbest.raw",
                     "auto-r", "best", 16),
    "MR_dev_auto": (TESTDATA / "MR_dev_auto.micw", TESTDATA / "MR_dev_auto.raw",
                    "auto", "standard", 4),
    "wide_banded": (TESTDATA / "wide_banded.micw", TESTDATA / "wide_banded.raw",
                    "auto-fast", "standard", 8),
}
# r-mode batch: (tissue fixture, replicas, FLAG_RDENSE cleared); the
# plane is the letter after "tissue_"
R_FIXTURES = [f"tissue_{c}_{s}" for s in ("rstd", "rbest") for c in "rgb"]
R_BATCH = ([(n, 64, False) for n in R_FIXTURES + ["tissue_g_pdr", "tissue_g_zzr_alias"]]
           + [("tissue_g_pdr", 32, True), ("tissue_g_zzr_alias", 32, True)])
# Phase 6: (name, container or None to encode here, predictor, entropy,
# replicas); the pixels come from _post_pixels.
POST_BATCH = [
    ("MR_dev_auto", TESTDATA / "MR_dev_auto.micw", "auto", "standard", 128),
    ("CT_dev_zz", None, "zz", "standard", 64),
    ("CT_dev_zz_alias", None, "zz", "alias", 64),
    ("wide_800", None, "auto-fast", "standard", 32),
    ("wide_640", None, "auto-fast", "standard", 32),
    ("tissue_g_500", None, "auto-r", "standard", 32),
    ("CT_dev_tl13", PORT_DATA / "CT_dev_tl13.micw", None, None, 32),
]
CT_TL15 = PORT_DATA / "CT_dev_1strip_tl15.micw"
# name -> (CUDA source, file:line of the Pallas kernel body it replaces)
KERNELS = {
    "rans_decode_zzd": ("mic_tpu_torch/csrc/rans_decode.cu", "mic_tpu/tpu/pallas_rans.py:415"),
    "rans_decode_alias": ("mic_tpu_torch/csrc/rans_decode.cu", "mic_tpu/tpu/pallas_rans.py:567"),
    "rans_encode": ("mic_tpu_torch/csrc/rans_encode.cu", "mic_tpu/tpu/pallas_enc.py:115"),
    "rans_encode_alias": ("mic_tpu_torch/csrc/rans_encode.cu", "mic_tpu/tpu/pallas_enc.py:115"),
    "rans_decode_rle": ("mic_tpu_torch/csrc/rans_rle.cu", "mic_tpu/tpu/pallas_rans.py:1078"),
    "rans_decode_rle_alias": ("mic_tpu_torch/csrc/rans_rle.cu",
                              "mic_tpu/tpu/pallas_rans.py:1095"),
    "rans_decode_packed": ("mic_tpu_torch/csrc/rans_decode.cu", "mic_tpu/tpu/pallas_rans.py:233"),
    "rans_decode": ("mic_tpu_torch/csrc/rans_decode.cu", "mic_tpu/tpu/pallas_rans.py:52"),
    "tans_decode": ("mic_tpu_torch/csrc/tans_decode.cu", "mic_tpu/tpu/pallas_tans.py:79"),
}
# The bound of a kernel's work: the larger of its bytes (every input read
# once, every output written once) over the H100 SXM's 3.35 TB/s and its
# integer operations over 67 T/s (the guide's CUDA-core rate, float32
# outside the tensor cores; it lists no integer rate).  Operations per
# output element, counted from each kernel's step in csrc/: the entropy
# step (slot mask, table reads, bound checks, shift, multiply-add, renorm
# test and word merge: 9; the alias front end 14), plus the fused
# inverse's unzigzag and sum (4), plus the r-kernels' run search and
# literal read per pixel (16); the encoder's division by magic multiply,
# state update and renorm test (12; the alias slot search 8 more); the
# tANS step per symbol (table and alphabet reads with their bound checks,
# the active test, the lane scan, the window clamp, two word reads, the
# funnel shift, mask and state add, the cursor update and the store: 24).
MEM_BPS, CORE_OPS = 3.35e12, 67e12
OPS_PER_ELEMENT = {"rans_decode_zzd": 13, "rans_decode_alias": 18, "rans_decode_packed": 9,
                   "rans_decode": 9, "rans_decode_rle": 29, "rans_decode_rle_alias": 34,
                   "rans_encode": 12, "rans_encode_alias": 20, "tans_decode": 24}


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the current stream, after one
    warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profiled(fn, records: list | None = None):
    """Run ``fn()`` under torch.profiler; returns (result, wall ms, device
    ms by kernel name, device span ms).  The name dict is empty when the
    profiler recorded no device events.  ``records``, when a list,
    receives (name, start us from the first, duration us) per device
    event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    span = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
            if events else 0) / 1e3
    if records is not None and events:
        t_first = min(e.time_range.start for e in events)
        records.extend((e.name, e.time_range.start - t_first, e.time_range.elapsed_us())
                       for e in events)
    return out, wall_ms, by_name, span


def _profile(plan) -> None:
    """Device time of one ``plan.run()`` by kernel, from torch.profiler."""
    _out, wall_ms, by_name, span = _profiled(plan.run)
    if not by_name:
        print(f"profile: wall_ms={wall_ms:.3f}; no device events recorded "
              "(device breakdown not measured)")
        return
    busy = sum(by_name.values())
    print(f"profile: one plan.run(): wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
          f"device_span_ms={span:.3f} idle_share_of_span={1 - busy / span:.3f} "
          f"device_kernel_names={len(by_name)}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile: {ms:8.3f} ms {100 * ms / busy:5.1f}%  {name[:110]}")


def _max_abs_err(got, want) -> int:
    """Largest difference of the bit-view values over all outputs."""
    import torch

    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def _account(r, name, inputs, outputs, ms, plain_ms) -> None:
    """Adds one timed kernel call to its report entry: milliseconds, and
    the bytes and operations its bound is computed from."""
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    r["bytes"] += sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    r["ops"] += OPS_PER_ELEMENT[name] * sum(t.numel() for t in outputs)


def _encode_kernels_vs_plain(dev, report) -> None:
    """Phase 2, encode half: both forms of the encode kernel against their
    plain versions on CT_dev x128's candidate operands."""
    import numpy as np
    import torch

    from mic_tpu_torch.tpu import rans_encode as renc
    from mic_tpu_torch.tpu.strips import ALIAS_TABLE_LOG, MAX_TABLE_LOG, micw_parse

    blob = (TESTDATA / "CT_dev.micw").read_bytes()
    w, h, _ns, _sh, mv = micw_parse(blob)[:5]
    px = np.fromfile(TESTDATA / "CT_dev.raw", dtype="<u2")
    reps = 128
    for alias, name in ((False, "rans_encode"), (True, "rans_encode_alias")):
        plan = renc.MicwEncodePlan([(px, w, h, mv)], "alias" if alias else "standard",
                                   "auto-fast")
        staged = renc.stage_encode_batch(
            [j[0] for j in plan.jobs[alias]], on_error="none", alias=alias,
            max_table_log=ALIAS_TABLE_LOG if alias else MAX_TABLE_LOG)
        staged.ops = tuple(np.ascontiguousarray(np.tile(a, (reps,) + (1,) * (a.ndim - 1)))
                           for a in staged.ops)
        ops = renc.staged_to_device(staged, dev)
        kernel = getattr(renc, name)
        plain = getattr(renc, name + "_plain")
        got = kernel(*ops, steps=staged.steps)
        want = plain(*ops, steps=staged.steps)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if not all(torch.equal(g, x) for g, x in zip(got, want)):
            raise AssertionError(f"{name}: kernel != plain (max abs err {err})")
        ms = _cuda_ms(lambda: kernel(*ops, steps=staged.steps), 10)
        plain_ms = _cuda_ms(lambda: plain(*ops, steps=staged.steps), 1)
        report[name]["max_abs_err"] = err
        _account(report[name], name, ops, got, ms, plain_ms)
        print(f"kernel-vs-plain {name} CT_dev{'_alias' if alias else ''}x{reps} "
              f"streams={ops[0].shape[0]} steps={staged.steps} table_width={ops[1].shape[1]} "
              f"equal=True kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}")


def _tissue_plane(c):
    import numpy as np

    px = np.fromfile(TESTDATA / "tissue_dev.raw", "u1").reshape(384, 512, 3)
    return px[:, :, "rgb".index(c)].astype(np.uint16).ravel()


def _r_batch():
    """Phase 5's containers and expected pixels, in batch order."""
    planes = {c: _tissue_plane(c) for c in "rgb"}
    blobs, expected = [], []
    for name, reps, stripped in R_BATCH:
        blob = bytearray((PORT_DATA / f"{name}.micw").read_bytes())
        if stripped:
            blob[22] &= ~0x10  # FLAG_RDENSE
        blob = bytes(blob)
        blobs += [blob] * reps
        expected += [planes[name[len("tissue_")]]] * reps
    return blobs, expected


def _rle_kernels_vs_plain(dev, report) -> None:
    """Phase 2, r-mode half: both r-kernels against their plain versions on
    every bucket of phase 5's batch, with the bucket's own ``dense`` (timed)
    and with the other one."""
    import torch

    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch.tpu import rans_decode as rd

    plain = {rd.rans_decode_rle: rd.rans_decode_rle_plain,
             rd.rans_decode_rle_alias: rd.rans_decode_rle_alias_plain}
    plan = MicwDecodePlan(_r_batch()[0], dev)
    for key, b in plan.buckets.items():
        for own in (True, False):
            kw = dict(b.kwargs, dense=b.kwargs["dense"] == own)
            name = b.fn.__name__
            got = b.fn(*b.ops, **kw)
            want = plain[b.fn](*b.ops, **kw)
            torch.cuda.synchronize()
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"{name} {key} {kw}: kernel != plain (max abs err {err})")
            r = report[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            line = (f"kernel-vs-plain {name} r-batch bucket={key} strips={b.n} "
                    f"steps={kw['steps']} out_rows={kw['out_rows']} maxr={kw['maxr']} "
                    f"dense={kw['dense']} equal=True")
            if own:
                ms = _cuda_ms(lambda: b.fn(*b.ops, **kw), 10)
                plain_ms = _cuda_ms(lambda: plain[b.fn](*b.ops, **kw), 1)
                _account(r, name, b.ops, (got,), ms, plain_ms)
                line += f" kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}"
            print(line)
    del plan


def _rle_phase(dev):
    """Phase 5: the r-mode decode path, then the encode of the six auto-r
    settings compared with their fixtures; returns the phase's launches."""
    import numpy as np
    import torch

    from mic_tpu_torch import MicwDecodePlan, micw_compress_device_many
    from mic_tpu_torch.tpu import rans_decode as rd

    batch, expected = _r_batch()
    timed_bytes = 2 * sum(e.size for e in expected)  # every strip is an r-mode strip
    rd.rans_decode_rle.launches = 0
    rd.rans_decode_rle_alias.launches = 0
    t0 = time.perf_counter()
    plan = MicwDecodePlan(batch, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = plan.run()
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    launches = {"rans_decode_rle": rd.rans_decode_rle.launches,
                "rans_decode_rle_alias": rd.rans_decode_rle_alias.launches}
    n_strips = sum(b.n for b in plan.buckets.values())
    mism = plan.verify_batch(decoded, expected)
    outs = plan.assemble(decoded)
    bad = [i for i, ((px, _w, _h), exp) in enumerate(zip(outs, expected))
           if px.dtype != np.uint16 or not np.array_equal(px, exp)]
    print(f"r-mode path: {len(batch)} images, {n_strips} entropy strips in "
          f"{len(plan.buckets)} buckets, stage_s={stage_s:.3f} "
          f"first_run_s={first_run_s:.3f} mismatches={mism} bad_images={len(bad)} "
          f"launches={launches}")
    if mism or bad:
        raise AssertionError(f"r-mode path decoded wrong pixels: {mism} mismatches, "
                             f"images {bad[:10]}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the r-mode path")
    run_ms = _cuda_ms(plan.run, 5)
    print(f"r-mode path: {run_ms:.3f} ms per plan.run(), "
          f"{timed_bytes / (run_ms / 1e3) / 1e9:.3f} GB/s of decoded u16 pixels "
          f"({timed_bytes} bytes)")
    _profile(plan)
    del plan, decoded, outs

    images = [(_tissue_plane(c), 512, 384, 255) for c in "rgb"]
    for ent, tag in (("standard", "rstd"), ("best", "rbest")):
        t0 = time.perf_counter()
        blobs = micw_compress_device_many(images, dev, entropy=ent, predictor="auto-r")
        enc_s = time.perf_counter() - t0
        want = [(PORT_DATA / f"tissue_{c}_{tag}.micw").read_bytes() for c in "rgb"]
        print(f"r-mode encode auto-r/{ent}: 3 planes in {enc_s:.3f} s, "
              f"equal_to_fixture={blobs == want}")
        if blobs != want:
            raise AssertionError(f"auto-r/{ent} containers differ from the tissue fixtures")
    return launches


def _encode_phase(dev):
    """Phase 4: the encode path over every fixture setting; returns the
    launch counts of the phase and the auto-fast containers with their
    expected pixels."""
    import numpy as np
    import torch

    from mic_tpu_torch.tpu import rans_encode as renc
    from mic_tpu_torch.tpu.strips import (
        ALIAS_TABLE_LOG,
        MAX_TABLE_LOG,
        micw_band_info,
        micw_parse,
    )

    tot = {"bytes": 0, "cand_s": 0.0, "enc_s": 0.0, "sel_s": 0.0, "kernel_ms": 0.0,
           "stage_s": 0.0}
    launches = {"rans_encode": 0, "rans_encode_alias": 0}
    decode_batch, decode_expected = [], []
    for name, (blob_p, raw_p, pred, ent, reps) in ENCODE.items():
        want = blob_p.read_bytes()
        w, h, _ns, _sh, mv = micw_parse(want)[:5]
        band = micw_band_info(want)
        if band is not None:
            w, h = band
        px = np.fromfile(raw_p, dtype="<u2")
        images = [(px, w, h, mv)] * reps
        # The main path, unprofiled: its launches and its rate count.
        renc.rans_encode.launches = 0
        renc.rans_encode_alias.launches = 0
        t0 = time.perf_counter()
        plan = renc.MicwEncodePlan(images, ent, pred)
        cand_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = plan.encode(dev)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = plan.assemble(results)
        sel_s = time.perf_counter() - t0
        run = (renc.rans_encode.launches, renc.rans_encode_alias.launches)
        launches["rans_encode"] += run[0]
        launches["rans_encode_alias"] += run[1]
        # Kernel milliseconds from a second device-encode call under
        # torch.profiler; its launches are not counted.
        _r, _wall, by_name, _span = _profiled(lambda: plan.encode(dev))
        kernel_ms = sum(v for k, v in by_name.items() if "rans_enc_kernel" in k)
        # The host staging of the device-encode call (histogram,
        # normalization, ncount header, tables, ranks), timed in a third,
        # separate run with no launch.
        t0 = time.perf_counter()
        for alias, jobs in plan.jobs.items():
            if jobs:
                renc.stage_encode_batch(
                    [j[0] for j in jobs], on_error="none", alias=alias,
                    max_table_log=ALIAS_TABLE_LOG if alias else MAX_TABLE_LOG)
        stage_s = time.perf_counter() - t0
        bad = [i for i, o in enumerate(outs) if o != want]
        n_bytes = px.nbytes * reps
        total_s = cand_s + enc_s + sel_s
        print(f"encode {name} x{reps} {pred}/{ent}: streams std={len(plan.jobs[False])} "
              f"alias={len(plan.jobs[True])} candidates_s={cand_s:.3f} "
              f"device_encode_s={enc_s:.3f} (host staging_s={stage_s:.3f}, separate run) "
              f"kernel_ms={kernel_ms:.3f} (profiled run) "
              f"select_s={sel_s:.3f} total_s={total_s:.3f} "
              f"MBps={n_bytes / total_s / 1e6:.3f} launches(std,alias)={run} "
              f"equal_to_fixture={not bad}")
        if bad:
            raise AssertionError(f"encode {name}: containers {bad[:10]} differ from the fixture")
        if not by_name:
            print(f"encode {name}: no device events recorded (kernel ms not measured)")
        for k, v in (("bytes", n_bytes), ("cand_s", cand_s), ("enc_s", enc_s),
                     ("sel_s", sel_s), ("kernel_ms", kernel_ms), ("stage_s", stage_s)):
            tot[k] += v
        if pred == "auto-fast":
            decode_batch += outs
            decode_expected += [px] * reps
    total_s = tot["cand_s"] + tot["enc_s"] + tot["sel_s"]
    host_s = total_s - tot["kernel_ms"] / 1e3
    print(f"encode path: {sum(v[4] for v in ENCODE.values())} images, "
          f"{tot['bytes']} input bytes in {total_s:.3f} s = {tot['bytes'] / total_s / 1e6:.3f} MB/s "
          f"(unprofiled); candidates_s={tot['cand_s']:.3f} device_encode_s={tot['enc_s']:.3f} "
          f"(host staging_s={tot['stage_s']:.3f}, separate runs) "
          f"select_s={tot['sel_s']:.3f} kernel_ms={tot['kernel_ms']:.3f} (profiled runs) "
          f"host_share={host_s / total_s:.5f} launches={launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the encode path")
    return launches, decode_batch, decode_expected


def _post_pixels():
    """name -> (pixels, width, height, max_value) of phase 6's images."""
    import numpy as np

    ct = np.fromfile(TESTDATA / "CT_dev.raw", dtype="<u2")
    wide = np.fromfile(TESTDATA / "wide_banded.raw", dtype="<u2").reshape(512, 1024)
    tissue = _tissue_plane("g").reshape(384, 512)[:, :500]
    out = {"MR_dev_auto": (np.fromfile(TESTDATA / "MR_dev_auto.raw", dtype="<u2"), 256, 256),
           "CT_dev_zz": (ct, 512, 512), "CT_dev_zz_alias": (ct, 512, 512),
           "wide_800": (np.ascontiguousarray(wide[:, :800]).ravel(), 800, 512),
           "wide_640": (np.ascontiguousarray(wide[:, :640]).ravel(), 640, 512),
           "tissue_g_500": (np.ascontiguousarray(tissue).ravel(), 500, 384),
           "CT_dev_tl13": (ct, 512, 512)}
    return {k: (px, w, h, int(px.max())) for k, (px, w, h) in out.items()}


def _post_batch(dev):
    """Phase 6's containers (fixtures, or encoded here on the card by the
    port's encoder), expected pixels and names, in batch order."""
    import torch

    from mic_tpu_torch import micw_compress_device_many

    images = _post_pixels()
    blobs, expected, names = [], [], []
    t0 = time.perf_counter()
    for name, path, pred, ent, reps in POST_BATCH:
        px, w, h, mv = images[name]
        if path is not None:
            blob = path.read_bytes()
        else:
            (blob,) = micw_compress_device_many([(px, w, h, mv)], dev, entropy=ent,
                                                predictor=pred)
        blobs += [blob] * reps
        expected += [px] * reps
        names += [name] * reps
    torch.cuda.synchronize()
    print(f"post path: {len(set(names))} containers ready ({time.perf_counter() - t0:.3f} s, "
          f"5 encoded on the card)")
    return blobs, expected, names


_POST_FNS = ("rans_decode_packed", "rans_decode", "rans_decode_alias")


def _post_kernels_vs_plain(dev, report, blobs) -> None:
    """Phase 2, post half: the symbols-out kernels against their plain
    versions on every post bucket of phase 6's batch, and the two-table
    kernel at tl 15 (tables past the shared-memory limit)."""
    import torch

    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch.tpu import rans_decode as rd

    plans = [("post-batch", MicwDecodePlan(blobs, dev)),
             ("CT_dev_1strip_tl15x32", MicwDecodePlan([CT_TL15.read_bytes()] * 32, dev))]
    by_tl = {}
    for tag, plan in plans:
        for key, b in plan.buckets.items():
            if key[0] != "post":
                continue
            name = b.fn.__name__
            plain = getattr(rd, name + "_plain")
            got = b.fn(*b.ops, **b.kwargs)
            want = plain(*b.ops, **b.kwargs)
            torch.cuda.synchronize()
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"{name} {tag} {key}: kernel != plain (max abs err {err})")
            ms = _cuda_ms(lambda: b.fn(*b.ops, **b.kwargs), 10)
            plain_ms = _cuda_ms(lambda: plain(*b.ops, **b.kwargs), 1)
            r = report[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            line = (f"kernel-vs-plain {name} {tag} bucket={key} strips={b.n} "
                    f"steps={b.kwargs['steps']} table_width={b.ops[1].shape[1]} equal=True "
                    f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}")
            if name != "rans_decode_alias":  # its timed shapes are phase 3's
                _account(r, name, b.ops, (got,), ms, plain_ms)
            if name == "rans_decode":
                tl = b.ops[1].shape[1].bit_length() - 1
                smem = 8 * b.ops[1].shape[1]
                line += f" tl={tl} tables_bytes_per_strip={smem}"
                by_tl.setdefault(tl, [0, 0.0])
                by_tl[tl][0] += b.n
                by_tl[tl][1] += ms
            print(line)
    for tl, (n, ms) in sorted(by_tl.items()):
        print(f"two-table kernel at tl {tl}: {n} strips, {ms:.3f} ms over its buckets")
    del plans


def _post_phase(dev, blobs, expected, names):
    """Phase 6: the post-path decode; returns the run's launch counts."""
    import numpy as np
    import torch

    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch.tpu import rans_decode as rd
    from mic_tpu_torch.tpu.strips import STRIP_MODE_CONST, STRIP_MODE_RAW, micw_parse

    timed_bytes = 0
    for blob in blobs:
        bw, bh, _ns, strip_h, _mv, _gp, _lanes, strips = micw_parse(blob)
        timed_bytes += 2 * sum(min(strip_h, bh - i * strip_h) * bw
                               for i, st in enumerate(strips)
                               if st[5] not in (STRIP_MODE_RAW, STRIP_MODE_CONST))
    t0 = time.perf_counter()
    plan = MicwDecodePlan(blobs, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    fns = {n: getattr(rd, n) for n in (*_POST_FNS, "rans_decode_zzd")}
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    decoded = plan.run()
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in fns.items()}
    kinds = {}
    for key, b in plan.buckets.items():
        kind = f"{key[1]}:{key[2]}" if key[0] == "post" else f"fused:{key[0]}"
        kinds[kind] = kinds.get(kind, 0) + b.n
    n_strips = sum(b.n for b in plan.buckets.values())
    mism = plan.verify_batch(decoded, expected)
    outs = plan.assemble(decoded)
    bad = [i for i, ((px, _w, _h), exp) in enumerate(zip(outs, expected))
           if px.dtype != np.uint16 or not np.array_equal(px, exp)]
    print(f"post path: {len(blobs)} images, {n_strips} entropy strips in {len(plan.buckets)} "
          f"buckets {kinds}, stage_s={stage_s:.3f} first_run_s={first_run_s:.3f} "
          f"mismatches={mism} bad_images={len(bad)} launches={launches}")
    if mism or bad:
        raise AssertionError(f"post path decoded wrong pixels: {mism} mismatches, "
                             f"images {[names[i] for i in bad[:10]]}")
    for name in _POST_FNS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the post path")
    run_ms = _cuda_ms(plan.run, 3)
    print(f"post path: {run_ms:.3f} ms per plan.run(), "
          f"{timed_bytes / (run_ms / 1e3) / 1e9:.3f} GB/s of decoded u16 pixels "
          f"({timed_bytes} bytes)")
    _out, wall_ms, by_name, span = _profiled(plan.run)
    if not by_name:
        print(f"profile: wall_ms={wall_ms:.3f}; no device events recorded "
              "(device breakdown not measured)")
    else:
        busy = sum(by_name.values())
        ent = sum(v for k, v in by_name.items() if "rans_" in k)
        print(f"profile: one plan.run(): wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
              f"device_span_ms={span:.3f} idle_share_of_span={1 - busy / span:.3f} "
              f"entropy_kernels_ms={ent:.3f} ({100 * ent / busy:.1f}% of busy) "
              f"post_torch_ops_ms={busy - ent:.3f} device_kernel_names={len(by_name)}")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
            print(f"profile: {ms:8.3f} ms {100 * ms / busy:5.1f}%  {name[:110]}")
    # Wall time of each post bucket alone (host clock around a synchronised
    # call), to split the phase between the bucket kinds.
    for key, b in plan.buckets.items():
        b()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b()
        torch.cuda.synchronize()
        print(f"post path bucket {key}: strips={b.n} wall_ms={(time.perf_counter() - t0) * 1e3:.3f}")
    del plan, decoded, outs
    return launches

# Phase 7's archive batch: (reference fixture, replicas).  The kernel part
# is every entropy stream of these fixtures; the host part is the streams
# of REF_HOST, once each (the headers send 7 of them to the host).
REF_BATCH = [("MR_2s.mic", 64), ("MR_4s.mic", 64), ("MR_8s.mic", 64), ("MR_rans8.mic", 64),
             ("CT_pics8.pics", 32), ("MR_pics4.pics", 64), ("MR_pics8.pics", 64),
             ("tissue.mic3", 16), ("grey.mic3", 16)]
REF_HOST = ["CT_2s.mic", "CT_4s.mic", "CT_8s.mic", "CT_rans8.mic", "CT_pics4.pics"]
REF_HOST_STREAMS = 7


def _ref_streams(name):
    """The entropy streams of one reference fixture: a MIC1 payload, the
    strips of a PICS container, or the compressed planes of every tile of
    a MIC3 pyramid."""
    import struct

    from mic_tpu_torch.models.rgb import PLANE_COMPRESSED
    from mic_tpu_torch.parallel.strips import pics_strip_blobs
    from mic_tpu_torch.parallel.wsi import extract_tile_blob, read_mic3_header
    from mic_tpu_torch.utils.io import read_mic1

    data = (TESTDATA / name).read_bytes()
    if name.endswith(".mic"):
        return [read_mic1(data)[3]]
    if name.endswith(".pics"):
        return [blob for _y0, _h, blob in pics_strip_blobs(data)[3]]
    hdr, entries, off = read_mic3_header(data)
    out = []
    for g in range(len(entries)):
        blob = extract_tile_blob(data, entries, off, g)
        planes = [blob]
        if hdr.channels == 3 and hdr.bits_per_sample == 8:
            lens, o, planes = struct.unpack_from("<III", blob, 0), 12, []
            for ln in lens:
                planes.append(blob[o:o + ln])
                o += ln
        out += [p[1:] for p in planes if p and p[0] == PLANE_COMPRESSED]
    return out


def _ref_batch():
    """Phase 7's streams (replicas share one bytes object), the host
    indices the headers give (1-state, or tableLog > 13), and for each
    kernel stream (by index) the bytes its decode needs: its bits, its own
    table and alphabet, its u16 symbols out (the kernel's bound)."""
    from mic_tpu_torch.ops.fse import read_ncount
    from mic_tpu_torch.tpu.tans_decode import TANS_MAX_TABLE_LOG, _pack_dtable, fse_parse_header

    batch, host, work = [], [], {}
    for name, reps in REF_BATCH + [(h, 1) for h in REF_HOST]:
        for blob in _ref_streams(name):
            n, count, body, coder = fse_parse_header(blob)
            norm, sl, tl, used = read_ncount(body)
            to_host = n == 1 or tl > TANS_MAX_TABLE_LOG
            nbytes = 0
            if not to_host:
                alpha = _pack_dtable(norm, sl, tl, coder)[1]
                nbytes = len(body) - used + 4 * ((1 << tl) + len(alpha)) + 2 * count
            for _ in range(reps):
                if to_host:
                    host.append(len(batch))
                else:
                    work[len(batch)] = nbytes
                batch.append(blob)
    return batch, host, work


def _tans_kernels_vs_plain(dev, report) -> None:
    """Phase 2, tANS half: the kernel against its plain version on every
    launch group of phase 7's batch.  The bound counts what the groups'
    streams need (their bits, tables and symbols), not the padded
    operands."""
    import torch

    from mic_tpu_torch.tpu import tans_decode as td

    batch, _host, work = _ref_batch()
    plan = td.TansDecodePlan(batch, dev)
    r = report["tans_decode"]
    for idx, counts, ops, kw in plan.groups:
        got = td.tans_decode(*ops, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = td.tans_decode_plain(*ops, **kw)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"tans_decode {kw}: kernel != plain (max abs err {err})")
        ms = _cuda_ms(lambda: td.tans_decode(*ops, **kw), 10)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        n_sym = sum(counts)
        r["bytes"] += sum(work[i] for i in idx)
        r["ops"] += OPS_PER_ELEMENT["tans_decode"] * n_sym
        print(f"kernel-vs-plain tans_decode group N={kw['n_states']} streams={len(idx)} "
              f"steps={kw['steps']} table_log={kw['table_log']} "
              f"alphabet_width={ops[4].shape[1]} symbols={n_sym} equal=True "
              f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} (one call)")
    del plan


def _series_frames():
    """The frames of tests/data/torch_port/MR_series_{ind,tmp}.mic2 (made
    from MR_2s.raw)."""
    import numpy as np

    mr = np.fromfile(TESTDATA / "MR_2s.raw", dtype="<u2").reshape(256, 256)
    return {"ind": [mr, mr[::-1], np.roll(mr, 3, axis=1)],
            "tmp": [np.roll(mr, k, axis=0) for k in range(3)]}


def _ref_entry_points(dev) -> None:
    """Phase 7, second half: every entry point of tpu.ref_decode once, and
    ingest_plan, against the fixtures' pixels."""
    import numpy as np
    import torch

    from mic_tpu_torch import (
        decompress_frames_device,
        decompress_mic2_device,
        decompress_mic2_frame_device,
        decompress_pics_device_many,
        decompress_wsi_level_device,
        decompress_wsi_region_device,
        decompress_wsi_tile_device,
        fse_decompress_device_batch,
        ingest_plan,
    )
    from mic_tpu_torch.parallel.strips import pics_strip_blobs
    from mic_tpu_torch.tpu import rans_decode as rd
    from mic_tpu_torch.tpu import rans_encode as renc
    from mic_tpu_torch.tpu.ref_decode import _invert
    from mic_tpu_torch.tpu.tans_decode import tans_decode
    from mic_tpu_torch.utils.io import read_mic1

    def raw(name, dtype="<u2"):
        return np.fromfile(TESTDATA / f"{name}.raw", dtype=dtype)

    def check(what, ok):
        print(f"entry point {what}: equal={ok}")
        if not ok:
            raise AssertionError(f"{what} decoded wrong pixels")

    def counted(what, fn, wrappers=(tans_decode,)):
        """fn() with the wrappers' launch counts set to 0 just before it;
        fails unless each of them launched in that call."""
        for w in wrappers:
            w.launches = 0
        out = fn()
        counts = {w.__name__: w.launches for w in wrappers}
        print(f"launches {what}: {counts}")
        if min(counts.values()) <= 0:
            raise AssertionError(f"{what} did not launch {counts}")
        return out

    # MIC1 frames, and the same batch split into its entropy and post stages.
    names = ["MR_2s", "MR_4s", "MR_8s", "MR_rans8"] * 8
    mic1 = {n: read_mic1((TESTDATA / f"{n}.mic").read_bytes()) for n in set(names)}
    blobs, dims = [mic1[n][3] for n in names], [mic1[n][:2] for n in names]
    t0 = time.perf_counter()
    outs = counted("decompress_frames_device", lambda: decompress_frames_device(blobs, dims, dev))
    total_s = time.perf_counter() - t0
    check(f"decompress_frames_device MR x8 ({len(blobs)} frames, {total_s:.3f} s)",
          all(np.array_equal(o, raw(n)) for o, n in zip(outs, names)))
    t0 = time.perf_counter()
    syms = counted("fse_decompress_device_batch (frames)",
                   lambda: fse_decompress_device_batch(blobs, dev))
    ent_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for sy, (w, h) in zip(syms, dims):
        _invert(sy, w, h, "avg")
    post_s = time.perf_counter() - t0
    px_bytes = sum(2 * w * h for w, h in dims)
    print(f"frames split: entropy_s={ent_s:.3f} (device batch, host copies included) "
          f"post_s={post_s:.3f} (host RLE + predictor inverse) for {px_bytes} pixel bytes: "
          f"{px_bytes / (ent_s + post_s) / 1e6:.3f} MB/s end to end")

    # PICS containers, four fixtures x4, and the same split.
    names = ["MR_pics4", "MR_pics8", "CT_pics4", "CT_pics8"] * 4
    pics = {n: (TESTDATA / f"{n}.pics").read_bytes() for n in set(names)}
    t0 = time.perf_counter()
    outs = counted("decompress_pics_device_many",
                   lambda: decompress_pics_device_many([pics[n] for n in names], dev))
    total_s = time.perf_counter() - t0
    check(f"decompress_pics_device_many x4 ({len(names)} containers, {total_s:.3f} s)",
          all(np.array_equal(px, raw(n)) for (px, _w, _h), n in zip(outs, names)))
    parsed = [pics_strip_blobs(pics[n]) for n in names]
    strips = [(st, p[0]) for p in parsed for st in p[3]]
    t0 = time.perf_counter()
    syms = counted("fse_decompress_device_batch (PICS strips)",
                   lambda: fse_decompress_device_batch([st[2] for st, _w in strips], dev))
    ent_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for sy, ((_y0, sh, _b), w) in zip(syms, strips):
        _invert(sy, w, sh, "avg")
    post_s = time.perf_counter() - t0
    px_bytes = sum(2 * p[0] * p[1] for p in parsed)
    print(f"pics split: entropy_s={ent_s:.3f} post_s={post_s:.3f} for {px_bytes} pixel bytes: "
          f"{px_bytes / (ent_s + post_s) / 1e6:.3f} MB/s end to end")

    # MIC2 series (independent and temporal), whole and one frame.
    for name, frames in _series_frames().items():
        blob = (PORT_DATA / f"MR_series_{name}.mic2").read_bytes()
        got, _hdr = counted(f"decompress_mic2_device MR_series_{name}",
                            lambda: decompress_mic2_device(blob, dev))
        check(f"decompress_mic2_device MR_series_{name}",
              all(np.array_equal(g, f.ravel()) for g, f in zip(got, frames)))
        px, _hdr = counted(f"decompress_mic2_frame_device MR_series_{name}",
                           lambda: decompress_mic2_frame_device(blob, 2, dev))
        check(f"decompress_mic2_frame_device MR_series_{name} frame 2",
              np.array_equal(px, frames[2].ravel()))

    # MIC3: grey (16-bit) and tissue (RGB, YCoCg-R) level 0 against the
    # pixels; tissue's level 1 has no .raw: the same call on the CPU.
    grey = (TESTDATA / "grey.mic3").read_bytes()
    gpx = raw("grey").reshape(256, 256)
    check("decompress_wsi_tile_device grey (0,0)",
          counted("decompress_wsi_tile_device grey",
                  lambda: decompress_wsi_tile_device(grey, 0, 0, 0, dev)) == gpx.tobytes())
    check("decompress_wsi_region_device grey",
          counted("decompress_wsi_region_device grey",
                  lambda: decompress_wsi_region_device(grey, 0, 10, 20, 200, 100, dev))
          == gpx[20:120, 10:210].tobytes())
    check("decompress_wsi_level_device grey level 0",
          counted("decompress_wsi_level_device grey",
                  lambda: decompress_wsi_level_device(grey, 0, dev)) == gpx.tobytes())
    tissue = (TESTDATA / "tissue.mic3").read_bytes()
    tpx = raw("tissue", np.uint8).reshape(384, 512 * 3)
    check("decompress_wsi_tile_device tissue (1,1)",
          counted("decompress_wsi_tile_device tissue",
                  lambda: decompress_wsi_tile_device(tissue, 0, 1, 1, dev))
          == tpx[256:, 768:].tobytes())
    check("decompress_wsi_region_device tissue",
          counted("decompress_wsi_region_device tissue",
                  lambda: decompress_wsi_region_device(tissue, 0, 200, 100, 100, 200, dev))
          == tpx[100:300, 600:900].tobytes())
    check("decompress_wsi_level_device tissue level 0",
          counted("decompress_wsi_level_device tissue level 0",
                  lambda: decompress_wsi_level_device(tissue, 0, dev)) == tpx.tobytes())
    check("decompress_wsi_level_device tissue level 1 (vs device=cpu)",
          counted("decompress_wsi_level_device tissue level 1",
                  lambda: decompress_wsi_level_device(tissue, 1, dev))
          == decompress_wsi_level_device(tissue, 1, torch.device("cpu")))

    # Ingest: MR_pics4 x16 + MR_4s x16 to MICW on the card, then decoded.
    mr4 = mic1["MR_4s"]
    ref_blobs = [pics["MR_pics4"]] * 16 + [mr4[3]] * 16
    dims = [None] * 16 + [mr4[:2]] * 16
    timings = {}
    t0 = time.perf_counter()
    plan = counted("ingest_plan",
                   lambda: ingest_plan(ref_blobs, dims, dev, entropy="device",
                                       device_encode=True, timings=timings),
                   (tans_decode, renc.rans_encode))
    total_s = time.perf_counter() - t0
    decoded = counted("ingest_plan's MicwDecodePlan.run", plan.run, (rd.rans_decode_zzd,))
    mism = plan.verify_batch(decoded, [raw("MR_pics4")] * 16 + [raw("MR_4s")] * 16)
    print(f"ingest_plan MR_pics4 x16 + MR_4s x16 (entropy=device, device_encode=True): "
          f"{total_s:.3f} s, " + " ".join(f"{k}={v:.3f}" for k, v in timings.items())
          + f" mismatches={mism}")
    if mism:
        raise AssertionError(f"ingest_plan's containers decode to wrong pixels: {mism}")


def _ref_phase(dev):
    """Phase 7: the reference-format archive batch through
    fse_decompress_device_batch, then the entry points; returns the
    batch call's launch count."""
    import numpy as np
    import torch

    from mic_tpu_torch import fse_decompress_device_batch
    from mic_tpu_torch.ops.fse_codec import fse_decompress_auto
    from mic_tpu_torch.tpu import tans_decode as td

    batch, host, _work = _ref_batch()
    td.tans_decode.launches = 0
    stats = {}
    t0 = time.perf_counter()
    syms = fse_decompress_device_batch(batch, dev, stats=stats)
    call_s = time.perf_counter() - t0
    launches = td.tans_decode.launches
    t0 = time.perf_counter()
    refs = {}
    for blob in batch:
        if id(blob) not in refs:
            refs[id(blob)] = fse_decompress_auto(blob)
    ref_s = time.perf_counter() - t0
    bad = [i for i, (g, b) in enumerate(zip(syms, batch))
           if g.dtype != np.uint16 or not np.array_equal(g, refs[id(b)])]
    print(f"reference path: {len(batch)} streams ({len(refs)} distinct), kernel={stats['kernel']} "
          f"host={len(stats['host'])} (from the headers: {len(host)}) launches={launches} "
          f"call_s={call_s:.3f} (host route and copies included) bad_streams={len(bad)} "
          f"(verified against the host decoder of each distinct blob, {ref_s:.3f} s)")
    if bad:
        raise AssertionError(f"reference path decoded wrong symbols: streams {bad[:10]}")
    if stats["host"] != host or len(host) != REF_HOST_STREAMS:
        raise AssertionError(f"host route {stats['host']} != the headers' {host}")
    if launches <= 0:
        raise AssertionError("tans_decode was not launched by the reference path")
    del syms

    t0 = time.perf_counter()
    plan = td.TansDecodePlan(batch, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    run_ms = _cuda_ms(plan.run, 5)
    sym_bytes = 2 * plan.stats["symbols"]
    print(f"reference path: {run_ms:.3f} ms per plan.run(), "
          f"{sym_bytes / (run_ms / 1e3) / 1e9:.3f} GB/s of u16 symbols ({sym_bytes} bytes, "
          f"{plan.stats['kernel']} kernel streams in {plan.stats['groups']} launches), "
          f"stage_s={stage_s:.3f}")
    # Device time of each launch from CUDA events (the run's own split).
    for (idx, _counts, ops, kw) in plan.groups:
        ms = _cuda_ms(lambda: td.tans_decode(*ops, **kw), 3)
        print(f"reference path launch N={kw['n_states']} streams={len(idx)} "
              f"steps={kw['steps']}: {ms:.3f} ms")
    # torch.profiler's view of one run.  Its idle share counts only when
    # the trace holds one kernel record per launch; otherwise the records
    # it has are listed and the idle share is not measured.
    records = []
    _out, wall_ms, by_name, span = _profiled(plan.run, records)
    n_tans = sum(1 for name, _t, _d in records if "tans_kernel" in name)
    if n_tans == len(plan.groups):
        busy = sum(by_name.values())
        print(f"profile: one plan.run(): wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
              f"device_span_ms={span:.3f} idle_share_of_span={1 - busy / span:.3f} "
              f"tans_kernel_records={n_tans} of {len(plan.groups)} launches")
    else:
        print(f"profile: one plan.run(): wall_ms={wall_ms:.3f}; the trace holds "
              f"{n_tans} tans_kernel records for {len(plan.groups)} launches: "
              "idle share not measured")
    for name, t_us, dur_us in records:
        print(f"profile record: {name[:60]} start_us={t_us:.3f} dur_us={dur_us:.3f}")
    del plan, _out
    _ref_entry_points(dev)
    return {"tans_decode": launches}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch._build import build, kernel_library
    from mic_tpu_torch.tpu import rans_decode as rd
    from mic_tpu_torch.tpu.strips import STRIP_MODE_CONST, STRIP_MODE_RAW, micw_parse

    dev = torch.device("cuda", 0)
    # --- 1. setup -----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    lib_path = build()
    kernel_library()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib_path.name})")
    log = lib_path.with_suffix(".log")
    if log.exists():  # absent when the library was built by an earlier run
        text = log.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", text))
        print(f"ptxas: {len(regs)} kernel instances, {min(regs)}-{max(regs)} registers, "
              f"{spills} bytes of spill stores")

    blobs = {k: v[0].read_bytes() for k, v in BATCH.items()}
    raws = {k: np.fromfile(v[1], dtype="<u2") for k, v in BATCH.items()}
    wrappers = {"rans_decode_zzd": (rd.rans_decode_zzd, rd.rans_decode_zzd_plain),
                "rans_decode_alias": (rd.rans_decode_alias, rd.rans_decode_alias_plain)}

    # --- 2. each kernel against its plain version, main-path shapes --------
    report = {name: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
              for name in KERNELS}
    _encode_kernels_vs_plain(dev, report)
    _rle_kernels_vs_plain(dev, report)
    post_blobs, post_expected, post_names = _post_batch(dev)
    _post_kernels_vs_plain(dev, report, post_blobs)
    _tans_kernels_vs_plain(dev, report)
    for name, reps in (("CT_dev", 256), ("CT_dev_alias", 256), ("MR_dev_alias", 512)):
        plan = MicwDecodePlan([blobs[name]] * reps, dev)
        for key, b in plan.buckets.items():
            variants = [b.kwargs]
            if b.fn is rd.rans_decode_alias and name == "MR_dev_alias":
                variants.append(dict(b.kwargs, vdd_ws=0, fused=False))
            for kw in variants:
                wname = b.fn.__name__
                kernel, plain = wrappers[wname]
                got = kernel(*b.ops, **kw)
                want = plain(*b.ops, **kw)
                torch.cuda.synchronize()
                err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
                if not torch.equal(got, want):
                    raise AssertionError(f"{wname} {name} {key} {kw}: kernel != plain "
                                         f"(max abs err {err})")
                ms = _cuda_ms(lambda: kernel(*b.ops, **kw), 10)
                plain_ms = _cuda_ms(lambda: plain(*b.ops, **kw), 2)
                r = report[wname]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if name in ("CT_dev", "CT_dev_alias"):  # one main-path image's buckets
                    _account(r, wname, b.ops, (got,), ms, plain_ms)
                print(f"kernel-vs-plain {wname} {name}x{reps} bucket={key} "
                      f"strips={b.n} steps={kw['steps']} "
                      f"{'' if kw.get('fused', True) else 'fused=False '}"
                      f"equal=True kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}")
        del plan

    # --- 3. decode path -------------------------------------------------------
    names = [k for k, v in BATCH.items() for _ in range(v[2])]
    batch = [blobs[k] for k in names]
    expected = [raws[k] for k in names]
    timed_bytes = 0
    for k in names:
        bw, bh, _ns, strip_h, _mv, _gp, _lanes, strips = micw_parse(blobs[k])
        timed_bytes += 2 * sum(min(strip_h, bh - i * strip_h) * bw
                               for i, st in enumerate(strips)
                               if st[5] not in (STRIP_MODE_RAW, STRIP_MODE_CONST))
    rd.rans_decode_zzd.launches = 0
    rd.rans_decode_alias.launches = 0
    t0 = time.perf_counter()
    plan = MicwDecodePlan(batch, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = plan.run()
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, (fn, _p) in wrappers.items()}
    n_strips = sum(b.n for b in plan.buckets.values())
    mism = plan.verify_batch(decoded, expected)
    outs = plan.assemble(decoded)
    bad = [i for i, ((px, _w, _h), exp) in enumerate(zip(outs, expected))
           if px.dtype != np.uint16 or not np.array_equal(px, exp)]
    print(f"decode path: {len(batch)} images, {n_strips} entropy strips in "
          f"{len(plan.buckets)} buckets, stage_s={stage_s:.3f} "
          f"first_run_s={first_run_s:.3f} mismatches={mism} bad_images={len(bad)} "
          f"launches={launches}")
    if mism or bad:
        raise AssertionError(f"decode path decoded wrong pixels: {mism} mismatches, images {bad[:10]}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the decode path")
    run_ms = _cuda_ms(plan.run, 5)
    print(f"decode path: {run_ms:.3f} ms per plan.run(), "
          f"{timed_bytes / (run_ms / 1e3) / 1e9:.3f} GB/s of decoded u16 pixels "
          f"({timed_bytes} bytes)")

    _profile(plan)
    del plan, decoded

    # --- 4. encode path -------------------------------------------------------
    enc_launches, enc_blobs, enc_expected = _encode_phase(dev)
    launches.update(enc_launches)
    plan = MicwDecodePlan(enc_blobs, dev)
    decoded = plan.run()
    mism = plan.verify_batch(decoded, enc_expected)
    print(f"encode path: {len(enc_blobs)} auto-fast containers decoded on the card, "
          f"mismatches={mism}")
    if mism:
        raise AssertionError(f"encoded containers decode to wrong pixels: {mism} mismatches")

    # --- 5. r-mode decode path ---------------------------------------------------
    launches.update(_rle_phase(dev))

    # --- 6. post-path decode -----------------------------------------------------
    post_launches = _post_phase(dev, post_blobs, post_expected, post_names)
    launches.update({k: post_launches[k] for k in ("rans_decode_packed", "rans_decode")})

    # --- 7. reference-format decode ---------------------------------------------
    launches.update(_ref_phase(dev))

    # --- 8. report ------------------------------------------------------------
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = report[name]
        mem_ms, ops_ms = r["bytes"] / MEM_BPS * 1e3, r["ops"] / CORE_OPS * 1e3
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": max(mem_ms, ops_ms),
                        "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
                        "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
