#!/usr/bin/env python3
"""Smoke run of mic_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Setup: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit, builds the CUDA kernels from ``mic_tpu_torch/csrc`` and,
   beside them in a thread, the C++ host tier (``native/micfse.cpp``) and
   its stage profiler (``native/prof_encode.cpp``) with the host
   compiler; prints the build seconds and nvcc's per-kernel resource
   report.
2. Kernel vs plain: each kernel against its plain PyTorch version on the
   card, whole output arrays, tolerance 0.  Decode: on the operands of
   the main path's buckets through the one-bucket wrappers (CT_dev x256
   = 1024 strips of 512 steps, CT_dev_alias x256, MR_dev_alias x512, plus
   the alias wrapper with fused=False), then every direct bucket of phase
   3's batch in the plan's one launch (``rans_decode_direct_groups``, pdd's
   column sum fused).  r-mode decode: on every bucket of phase 5's batch, each
   with its own ``dense`` and with the other one, then all 14 buckets in
   the plan's one launch (``rans_decode_rle_groups``).  Post path: the
   symbols-out front ends of the direct kernel through their one-bucket
   wrappers on every post bucket of phase 6's batch (packed tables; two
   tables at tl 13, staged; FF 41 with fused=False) and on
   CT_dev_1strip_tl15 x32 (tl 15: 196 KB of tables a strip, staged, a
   block each), then each of the two plans' merged launch
   (``rans_decode_direct_groups`` with the plan's packing, one launch),
   with its blocks, shared memory a block and blocks an SM, and the tl 15
   plan's launch once more with its tables read from device memory (the
   form tl 16 takes).  Post stage: ``csrc/post.cu`` (one launch of
   ``post.post_decode_groups`` with the plan's ``PostPacking``) against its
   plain twin ``post.post_batch`` on every post bucket of phase 6's batch,
   of phase 8's tile batch (``tissue_dev.mwr3`` x64: escaped zz and avg
   planes) and of CT_dev_1strip_tl15 x32, whole arrays, on the entropy
   launch's symbols and on a copy with ``POST_FLIPS`` symbols a bucket
   XORed with random words (damaged streams); with ms, plain ms, the bound
   and the launch's blocks.
   Encode: on the operands of CT_dev x128 under
   ``micw_compress_device_many`` (auto-fast; standard, and alias for the
   FF 41 form): 3 candidates x 4 strips x 128 = 1536 streams of 512
   steps, one image's operands replicated, with each stream's own table
   width as the main path passes it; prints ns a step of the launch, the
   shared memory a block, blocks an SM and waves.  tANS decode: on phase 7's
   archive batch, all four groups in one launch (N = 2, 4 and 8, FF 84
   and FF 08 tables, tableLogs and counts mixed in a group, each stream
   with its own table and alphabet sizes) and each group alone, with and
   without the sizes.  Transforms:
   the YCoCg-R pair on full-range random u16 planes and on the planes of
   phase 8's slide (16.5 M pixels each), the 5/3 lifting pair on random
   int32 rows in the u16 range at even, odd and non-multiple-of-4 widths.
   L-lane decode: the lanes kernel on every bucket of phase 10's batch
   (the tableLog 13-16 fixtures among them; every table is read from
   device memory) in both forms, each against its plain twin run once:
   the warp form through the one-bucket wrapper with the bucket's zzd /
   vdd / pdd inverse fused, the block form symbols out; then the plan's
   launch in both forms against them all; then CT_dev's first 128 rows at
   8, 512, 2048, 4096 and 16,384 lanes (the last three in the block form
   only); with ns a step, each launch's blocks, strips or threads a
   block, shared memory a block, blocks an SM and registers, and the
   half's wall seconds.
   Times from CUDA events after a warm-up (the plain tANS version: its
   one compared call).
3. Decode path: ``MicwDecodePlan`` over a mixed batch (CT_dev x256, the
   batch size the reference bench targets, plus MR_dev, MR_dev_alias,
   wide_banded and CT_dev_alias replicated); every strip of every
   replica is verified against the ``.raw`` pixels, in the first run and
   in the last timed one; one ``plan.run()`` must be exactly
   ``DIRECT_LAUNCHES_PER_RUN`` (1) launch of the direct kernel, holding
   both front ends, and the packing must be the direct-only layout
   (``PHASE3_PACKING``: 352 blocks of 69,760 bytes).  Prints staging
   seconds, decode GB/s over ``plan.run()``, the launch alone (CUDA
   events), the launch counts and a torch.profiler breakdown of one
   ``plan.run()`` by device kernel; the plan's timed runner
   (``make_timed_runner``): ``runner(1)`` must count 0 mismatches; its
   compare kernel (``csrc/verify.cu``, ``verify.count_mismatches``) must
   equal its plain twin on one run's outputs, clean and with 1000 pixels
   flipped in a copy of the largest bucket's output (totals and the
   flips' count), each timed by CUDA events; then ``RUNNER_PAIRS`` turns
   of one ``plan.run()`` and one ``runner(1)`` by their own CUDA events
   (runner(1) minus a run, medians), and ``RUNNER_BLOCKS`` turns of
   ``RUNNER_REPS`` runs back to back and ``runner(RUNNER_REPS)``, whose GB/s
   is printed beside theirs and the median ``plan.run()``'s and which must
   make one compare launch a run.  Then a 110,208 x 8 pdd image, encoded
   on the card, whose row leaves no room for the kernel's column carry:
   its plan must run the bucket unfused, in one launch, and decode it.
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
   every replica is verified against the plane's pixels, in the first run
   and in the last timed one; one ``plan.run()`` must be exactly
   ``RLE_LAUNCHES_PER_RUN`` (1) launch of the r-kernel, holding both front
   ends.  Prints staging seconds, decode GB/s over ``plan.run()``, the
   launch counts and a profiler breakdown.  Then the six auto-r settings are encoded on the card by
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
   encoder on the card.  Every strip of every replica is verified; one
   ``plan.run()`` must be exactly ``DIRECT_LAUNCHES_PER_RUN`` (1) launch of
   the direct kernel, and it must hold every post bucket's entropy stage:
   the packed, two-table and FF 41 symbols-out front ends each counted
   once; and exactly ``POST_LAUNCHES_PER_RUN`` (1) launch of the post
   kernel, with ``post_batch.calls`` 0 (the plain twin never runs on the
   card).  Prints staging seconds, decode GB/s over ``plan.run()``, the
   launch counts, the launch's blocks, and a profiler breakdown that
   splits the entropy kernels, the post kernel and the other ops.
7. Reference-format decode: ``fse_decompress_device_batch`` over an
   archive batch of the in-repo reference fixtures' entropy streams
   (MR MIC1 payloads at 2, 4 and 8 states and FF 08 x64, CT_pics8 strips
   x32, MR_pics4 and MR_pics8 strips x64, the compressed planes of
   tissue.mic3 and grey.mic3 x16: 1537 kernel streams, ~77 MB of u16
   symbols; and the 7 streams the headers route to the host, once:
   CT_{2s,4s,8s,rans8} at tableLog 16 and CT_pics4's strips 1-3 at 14).
   Every stream is verified against the port's host decoder of its
   distinct blob, the host-routed set must be exactly the headers', and
   the call, like every ``TansDecodePlan.run()``, must be exactly one
   kernel launch.  Prints staging seconds, ms per ``run()`` and GB/s of
   symbols over the kernel streams (CUDA events, staging excluded), the
   launch's blocks, pool, occupancy and tableLog histogram, each group
   alone (ms, and ns per step of its longest chain) beside the one
   launch, and a profiler line.  Then each entry point of
   ``tpu.ref_decode`` once on fewer replicas against the ``.raw`` pixels
   (MIC3 level 1 against the same call on the CPU), with the host seconds
   of the entropy and post stages, and ``ingest_plan(entropy="device",
   device_encode=True)`` on MR_pics4 x16 + MR_4s x16, whose decode plan
   must give back the pixels.
8. RGB and WSI containers: a WSI tile server and its ingest.  One slide
   is built from ``web/testdata/tissue_dev.raw`` (512x384 RGB): a mosaic
   of 8x8 copies, alternate copies mirrored, inside a constant white
   margin of one tile: 4608x3584 pixels, 49.5 MB of RGB, 252 tiles of
   256x256 at level 0 (60 of them constant) and 345 over the pyramid.
   ``w3d_compress(device_encode=True)`` encodes it on the card (seconds
   split into tiling, the forward transform and the encode call);
   ``w3d_decompress_level`` at levels 0 and 1 and ``w3d_decompress_region``
   over a region that crosses tile borders and touches a constant tile
   are verified against the source pixels (level 1 against the port's
   ``downsample2x_rgb``).  Level 0's decode is then staged once and timed
   with CUDA events, with a profiler split between the entropy kernels,
   the YCoCg-R kernel and the assemble's torch ops.  Then an RGB tile
   batch through ``micwr_decode_many``: ``tissue_dev.mwr3`` x64 (the
   "auto" planes: escaped zz and avg strips through the post path) and the
   same image under ``predictor="auto-r"``, encoded here, x64 (the
   r-kernels), every byte verified, the post kernel's launches counted
   (at least one); ``micwr_compress`` must reproduce
   ``tissue_dev.mwr3``.  Then the device-format MIC2 fixtures
   ``series_dev_{ind,tmp}.mic2``: decoded 16 times each against their
   ``.raw`` and re-encoded byte for byte.  The YCoCg-R wrappers, the
   encode wrapper and the decode wrappers of these paths must each have
   launched, counted from 0.
9. Wavelet: ``wavelet_forward_2d_separated`` and its inverse at 5 levels
   on ``CT_dev.raw`` (512x512), on the green channel of the slide
   (4608x3584) and on a 1001x749 crop of it (odd edges).  The forward
   must equal the same call on the CPU (the plain twins), the inverse
   must give back the input, and both row wrappers must have launched.
   Prints ms per transform (CUDA events).
10. L-lane (scan-tier) decode: ``MicwDecodePlan`` over the strips
   ``mic_tpu``'s plan sends to its scan tier, encoded at the start of phase
   2 by the port's host encoder copy (seconds printed): CT_dev at 64 lanes
   (auto-fast standard) x256, 1024 strips of 1024 steps, the batch size
   the reference bench targets; MR_dev at 64 lanes (alias) x64; CT_dev at
   256 and at 32 lanes x16; and the FF 41 fixtures at tableLog 13-16
   (``tests/data/torch_port/CT_dev_alias_tl*.micw``) x32.  Every strip of
   every replica is verified, in the first run and in the first and the
   last timed ones; one ``plan.run()`` must be exactly
   ``LANES_LAUNCHES_PER_RUN`` (1) launch of the lanes kernel, holding every
   bucket, each with its inverse fused: ``post_batch.calls`` must stay 0
   (its counter, not the profiler).  Prints the fused and unfused buckets,
   staging seconds, its blocks, shared memory a block and blocks an SM;
   then ``SCAN_REPS`` pairs of ``plan.run()`` and the launch alone,
   interleaved in one loop, each timed by its own CUDA events: the least,
   median and most ms of each and the run's GB/s; the plan's timed
   runner as in phase 3; a torch.profiler breakdown of one run.  Then the
   graft entry's tiny 64-lane batch (``dryrun.tiny_micw_batch``) through ``decode_strip_batch`` against its
   pixels, ``mict_decode_device`` on one 64-lane stream against the host
   decoder, and ``compress_multi_frame_device(lanes=64)`` on
   ``series_dev_ind.raw`` (three 512x512 frames), decoded and verified;
   each call's lanes launches counted from 0 and required > 0.  Prints
   the phase's wall seconds.
11. Multi-device (``tpu/mesh.py``): ``dryrun.dryrun_multichip`` over 2
   and 8 shards on the visible cards round-robin (every sharded path,
   each equal to the unsharded port call and to its pixels or symbols,
   each sharded call one kernel launch a shard); then on ``[cuda:0] * k``
   for k = 1, 2 and 4 (and over the cards themselves where more than one
   is visible): CT_dev x256's three buckets (phase 2's 1024 strips of 512
   steps) through ``decode_strips_sharded_pallas`` and the 64-lane CT_dev
   x256 (phase 10's) through ``decode_strips_sharded``, each equal to the
   unsharded call, every strip verified against ``CT_dev.raw``, one
   launch a shard; ms by CUDA events and host seconds of the sharded
   call, run twice, and the shards' launches alone beside the unsharded
   launch; phase 2's 1536 encode streams through both sharded encodes
   (widths sharded), equal to the unsharded outputs.
12. The reference formats' writers (host numpy, ``mic_tpu``'s bytes) and
   the round trip through the card.  (a) Every reference container of
   ``web/testdata`` (19: MIC1 at 2 / 4 / 8 states and rANS8, PICS at 4
   and 8 strips, PICA, MIC2 independent and temporal, MICR, MIC3 RGB and
   grey) rewritten from its ``.raw`` by the port's writers, equal to the
   file.  (b) A batch at a size users run: a ``SERIES_FRAMES``-frame
   512x512 series of ``CT_2s.raw`` (row and column rolls, as
   ``web/gen_testdata.py`` builds its series) and one of 256x256 frames
   of ``MR_2s.raw``, as MIC2 in both modes; a 2048x2048 mosaic of
   ``CT_2s.raw`` (4x4 copies with flips, a digital radiograph's size) as
   MIC1 at 2 / 4 / 8 states and rANS8 and as PICS of 8 strips at 4 and 8
   states; MIC3 of a 2048x2048 crop of phase 8's slide (256x256 tiles,
   the auto pyramid).  The writers run in ``WRITER_PROCS`` worker
   processes (the PICS writers on the C++ tier's thread pool, the others
   in numpy and Python); each prints its host seconds, MB/s and ratio.
   (c) The port's device readers on (b) and (a)'s containers,
   ``decompress_frames_device``, ``decompress_pics_device_many``,
   ``decompress_mic2_device`` (each series) and
   ``decompress_wsi_level_device`` (every level), every pixel against
   the input; each call's tANS launches counted from 0 beside its
   kernel-routed and host-routed stream counts (the CT streams, tableLog
   14-16, go to the host): the kernel must have launched exactly when a
   stream was routed to it, and each reader at least once; ms by CUDA
   events and GB/s of pixels.  (d) (b)'s MIC1 and PICS blobs through
   ``ingest_plan(..., device_encode=True, entropy="device")``, the plan
   decoded and every strip verified; the encode and direct kernels must
   have launched.  Prints the phase's wall seconds.
13. The host tier's last modules against the card.  (a) The host oracles
   (``strips.micw_decompress_host`` on every ``.micw`` of ``web/testdata``
   and ``tests/data/torch_port``, ``rgb_device.micwr_decompress_host`` on
   ``tissue_dev.mwr3``; numpy, host seconds a container) against
   ``micw_decode_many`` / ``micwr_decode_many`` on the card and the
   ``.raw`` pixels, every pixel; the card decode's launches counted from
   0 (the direct, r-mode and lanes kernels must each have launched).
   (b) ``python -m mic_tpu_torch.cli`` on ``CT_2s.raw`` (512x512), one
   process a run, all started together: ``-micw`` at each ``-entropy``
   with ``-predictor auto-fast`` and ``auto-r`` and no ``-device`` (the
   card), each equal to the port's host ``strips.micw_compress`` with
   that pairing; ``-micw -device`` (bare), equal to its zzd / standard
   bytes; each decoded back by the CLI's ``-decode`` in this process on
   the card, its launches counted; ``-wavelet`` and ``-gap``, decoded by
   the port's host decoders.  (c) The host pipelines at full size, in
   ``PIPELINE_PROCS`` spawned processes: wavelet V2 (5 levels), gap
   removal and the Delta+RLE+Huffman payload on phase 12's 2048x2048 CT
   mosaic, V1 and V1.5 on ``CT_2s.raw``; host seconds, MB/s and ratio of
   each encode and decode, every pixel equal.  (d) The 5/3 lift on the
   card (``kernels.wavelet_forward_2d_separated`` at the level count V2's
   header records) against the copied host
   ``ops.wavelet.wt53_forward_2d_separated`` on the mosaic, int32, the
   whole array, and its inverse back to the pixels; ms by CUDA events
   beside the host transform's seconds; its row launches join the
   report's ``wt53_rows_*`` counts.  (e) ``available()`` of the
   comparators ``utils.charls`` and ``utils.j2k``; where present, a round
   trip of ``CT_2s.raw`` and its ratio.  Prints the phase's wall seconds.
14. The C++ host tier (``mic_tpu_torch.native``), on the card machine's
   CPU in this process.  (a) The compiler, its flags, the host build's
   seconds (phase 1), a process's first call with the library built, the
   CPU model and thread count.  (b) Equality with
   the plain twins: every MIC1 and PICS fixture of ``web/testdata``
   decoded by ``decode_frame(tier="native")`` /
   ``decompress_strips_native`` and by the Python tier, both equal to the
   ``.raw``; the PICS containers (4 and 8 strips) and MIC1 frames of
   ``CT_2s.raw`` and ``MR_2s.raw`` at 2 / 4 / 8 states written by the
   C++ tier, equal to the Python writers'; every candidate stream of
   phase 4's settings through ``mict_encode`` (``_norm_and_header``,
   ``_lane_encode``) equal to the numpy twins.  (c) Timings on phase
   12's 2048x2048 CT mosaic (the least of ``NATIVE_REPS`` calls, host
   seconds and MB/s of pixels): ``decode_frame(tier="native")`` of its
   four MIC1, ``decompress_strips_native`` of its two PICS threaded and
   on one thread, the PICS writers (equal to phase 12's containers) and
   ``compress_frame_native`` (equal to phase 12's MIC1), each beside
   phase 12's; then ``ingest_plan(..., device_encode=True,
   entropy="native")`` on phase 12's six blobs with ``decode_s`` /
   ``encode_s`` / ``stage_s``, its encode and direct launches counted
   from 0 and required, every strip verified.  (d) ``prof_encode`` on
   ``CT_dev.raw``: the native encode's stages in MB/s.  Prints the
   phase's wall seconds.
15. Prints the kernel report as one JSON line (with each kernel's bound:
   the larger of its bytes over 3.35 TB/s and its integer operations over
   67 T/s, the H100 SXM's memory and CUDA-core rates), then, as the last
   line, ``{"ok": true, "device": {...}}``.

Every torch.profiler window (phases 3-8, 10) must hold one trace record
for each launch the port's wrappers counted in it, kernel by kernel
(``_profiled``), or the run fails.

Imports neither jax nor anything of mic_tpu.
"""

from __future__ import annotations

import json
import os
import re
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
# Phase 10: (name, pixels, width, height, lanes, predictor, entropy,
# replicas), encoded at the start of phase 2 by the port's host encoder;
# then the FF 41 fixtures above tableLog 12 (tableLog -> file), x32 each.
SCAN_ENCODE = [("CT_dev_l64", "CT_dev.raw", 512, 512, 64, "auto-fast", "standard", 256),
               ("MR_dev_alias_l64", "MR_dev.raw", 256, 256, 64, "auto-fast", "alias", 64),
               ("CT_dev_l256", "CT_dev.raw", 512, 512, 256, "auto-fast", "standard", 16),
               ("CT_dev_l32", "CT_dev.raw", 512, 512, 32, "auto-fast", "standard", 16)]
SCAN_FIXTURES = {13: "CT_dev_alias_tl13_l64.micw", 14: "CT_dev_alias_tl14.micw",
                 15: "CT_dev_alias_tl15.micw", 16: "CT_dev_alias_tl16_l64.micw"}
SCAN_FIXTURE_REPS = 32
SCAN_EXTRA_LANES = (8, 512, 2048, 4096, 16384)  # phase 2's lanes kernel, CT_dev's first 128 rows
# name -> (CUDA source, file:line of the Pallas kernel body it replaces)
KERNELS = {
    "rans_decode_zzd": ("mic_tpu_torch/csrc/rans_direct.cu", "mic_tpu/tpu/pallas_rans.py:415"),
    "rans_decode_alias": ("mic_tpu_torch/csrc/rans_direct.cu", "mic_tpu/tpu/pallas_rans.py:567"),
    # the same kernel over every direct bucket of a plan, both front ends,
    # pdd's column sum fused
    "rans_decode_direct_groups": ("mic_tpu_torch/csrc/rans_direct.cu",
                                  "mic_tpu/tpu/pallas_rans.py:415"),
    "rans_encode": ("mic_tpu_torch/csrc/rans_encode.cu", "mic_tpu/tpu/pallas_enc.py:115"),
    "rans_encode_alias": ("mic_tpu_torch/csrc/rans_encode.cu", "mic_tpu/tpu/pallas_enc.py:115"),
    "rans_decode_rle": ("mic_tpu_torch/csrc/rans_rle.cu", "mic_tpu/tpu/pallas_rans.py:1078"),
    "rans_decode_rle_alias": ("mic_tpu_torch/csrc/rans_rle.cu",
                              "mic_tpu/tpu/pallas_rans.py:1095"),
    # the same kernel over every r-bucket of a plan, both front ends
    "rans_decode_rle_groups": ("mic_tpu_torch/csrc/rans_rle.cu",
                               "mic_tpu/tpu/pallas_rans.py:1078"),
    # the same kernel's symbols-out front ends (the post path)
    "rans_decode_packed": ("mic_tpu_torch/csrc/rans_direct.cu", "mic_tpu/tpu/pallas_rans.py:233"),
    "rans_decode": ("mic_tpu_torch/csrc/rans_direct.cu", "mic_tpu/tpu/pallas_rans.py:52"),
    "tans_decode": ("mic_tpu_torch/csrc/tans_decode.cu", "mic_tpu/tpu/pallas_tans.py:79"),
    "ycocgr_forward": ("mic_tpu_torch/csrc/transforms.cu", "mic_tpu/tpu/kernels.py:44"),
    "ycocgr_inverse": ("mic_tpu_torch/csrc/transforms.cu", "mic_tpu/tpu/kernels.py:75"),
    "wt53_rows_forward": ("mic_tpu_torch/csrc/transforms.cu", "mic_tpu/tpu/kernels.py:109"),
    "wt53_rows_inverse": ("mic_tpu_torch/csrc/transforms.cu", "mic_tpu/tpu/kernels.py:130"),
    # no Pallas kernel: it replaces mic_tpu's scan tier, plain XLA (the
    # lax.scan of decode_strip_batch_impl's rans_one and its subst_one)
    "rans_decode_lanes": ("mic_tpu_torch/csrc/rans_lanes.cu", "mic_tpu/tpu/strips.py:762"),
    # the compare inside mic_tpu's timed runner (XLA-fused there), and its probe
    "count_mismatches": ("mic_tpu_torch/csrc/verify.cu", "mic_tpu/tpu/strips.py:2296-2306"),
    # no Pallas kernel: it replaces mic_tpu's post program, plain XLA
    # (_micw_post_batch over pipeline.py's expand, parse and inverses)
    "post_decode_groups": ("mic_tpu_torch/csrc/post.cu",
                           "mic_tpu/tpu/strips.py:1829, mic_tpu/tpu/pipeline.py:114-350"),
}
# The bound of a kernel's work: the larger of its bytes (every input read
# once, every output written once) over the H100 SXM's 3.35 TB/s and its
# integer operations over 67 T/s (the guide's CUDA-core rate, float32
# outside the tensor cores; it lists no integer rate).  Operations per
# output element, counted from each kernel's step in csrc/: the entropy
# step (slot mask, table reads, bound checks, shift, multiply-add, renorm
# test and word merge: 9; the alias front end 14), plus the fused
# inverse's unzigzag and sum (4), plus pdd's column sum in the merged
# direct launch (2: the add and the mask; each group of that launch counts
# at its wrapper's rate plus this), plus the r-kernels' run search and
# literal read per pixel (16); the encoder's division by magic multiply,
# state update and renorm test (12; the alias slot search 8 more); the
# tANS step per symbol (table and alphabet reads with their bound checks,
# the active test, the lane scan, the window clamp, two word reads, the
# funnel shift, mask and state add, the cursor update and the store: 24);
# the YCoCg-R pixel (four adds, two shifts, two zigzags or unzigzags, the
# masks and the packing: 15 for three outputs, 5 each); the lifting pair
# (two or three neighbour predicts, the update, the index arithmetic: 16
# for two outputs, 8 each); the lanes kernel's step per lane (slot mask,
# two table reads and the freq / bias split, shift, multiply-add, the
# active and renorm tests, the escape compare, two ballots and two masked
# popcounts, the rank adds, the word clip and merge, the state select, the
# escape select and the store: 24), plus in its fused form the inverse's
# unzigzag and sum per pixel as the direct kernel's rows count them
# (lanes_inverse, 4: zzd's row prefix, vdd's column add), plus pdd's
# column carry on its row prefix (lanes_column, 2: the add and the mask);
# the post kernel per output pixel (the expand's walk test and source
# select, the parse's delim compare and both marker hypotheses, the rank
# store, the inverse's unzigzag, add and mask, zz's segmented step: 16).
MEM_BPS, CORE_OPS = 3.35e12, 67e12
OPS_PER_ELEMENT = {"rans_decode_zzd": 13, "rans_decode_alias": 18,
                   "rans_decode_direct_groups": 2, "rans_decode_packed": 9,
                   "rans_decode": 9, "rans_decode_rle": 29, "rans_decode_rle_alias": 34,
                   "rans_encode": 12, "rans_encode_alias": 20, "tans_decode": 24,
                   "ycocgr_forward": 5, "ycocgr_inverse": 5,
                   "wt53_rows_forward": 8, "wt53_rows_inverse": 8, "rans_decode_lanes": 24,
                   "lanes_inverse": 4, "lanes_column": 2, "post_decode_groups": 16}
TILE = 256  # phase 8's tile edge and the slide's margin
RLE_LAUNCHES_PER_RUN = 1  # r-kernel launches per MicwDecodePlan.run(): all r-buckets at once
DIRECT_LAUNCHES_PER_RUN = 1  # direct-kernel launches per MicwDecodePlan.run(): all direct buckets
LANES_LAUNCHES_PER_RUN = 1  # lanes-kernel launches per MicwDecodePlan.run(): all scan buckets
POST_LAUNCHES_PER_RUN = 1  # post-kernel launches per MicwDecodePlan.run(): all post buckets
POST_FLIPS = 64  # symbols of each bucket's entropy output XORed in phase 2's damaged compare
POST_KERNEL = "post_groups_kernel"  # the post kernel's profiler name
SCAN_REPS = 20  # phase 10's timed pairs of plan.run() and the lanes launch alone
RUNNER_REPS = 20  # runs a timed runner makes in phases 3 and 10
RUNNER_PAIRS = 9  # turns of one plan.run() and one runner(1) in phases 3 and 10
RUNNER_BLOCKS = 5  # turns of RUNNER_REPS plan.run() back to back and runner(RUNNER_REPS)
MESH_DRYRUN = (2, 8)  # phase 11's dry runs, shards on the visible cards round-robin
MESH_SHARDS = (1, 2, 4)  # phase 11's full-width shard counts on one card
MESH_REPS = 256  # phase 11's CT_dev replicas, at 128 lanes (phase 2's) and at 64 (phase 10's)
PHASE3_PACKING = (352, 69760)  # phase 3's blocks and bytes a block (4 strips a block, kept)
WIDE_PDD = (110208, 8)  # phase 3's pdd image whose column carry leaves a block no room
SERIES_FRAMES = 32  # phase 12's MIC2 series (16.8 MB a mode at 512x512)
MOSAIC_COPIES = 4  # phase 12's mosaic: 4x4 copies of CT_2s.raw, 2048x2048
WSI_CROP = 2048  # phase 12's MIC3: a WSI_CROP square of phase 8's slide
WRITER_PROCS = 8  # phase 12's writer processes (one a CPU core of an 8-core H100 host)
PIPELINE_PROCS = 5  # phase 13's pipeline processes: one a pipeline run
NATIVE_REPS = 3  # phase 14's calls of each timed native decode and write (the least printed)
CLI_PAIRINGS = [(e, p) for p in ("auto-fast", "auto-r") for e in ("standard", "alias", "best")]
POST_FRONT_ENDS = ("rans_decode_packed", "rans_decode", "rans_decode_alias")  # phase 6's launch
ENTROPY_KERNELS = ("rans_", "groups_kernel")  # profiler names of the entropy kernels
TEARDOWN_SYNCS = 10  # synchronises after a profiler session, for CUPTI's finalise (_profiled)


def _clock(t_start: float, phase: int) -> None:
    """Prints the run's wall seconds so far at the start of ``phase``."""
    print(f"clock: {time.perf_counter() - t_start:.3f} s at the start of phase {phase}")


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


def _port_kernels() -> dict:
    """Kernel names in torch.profiler's trace -> the port's wrappers that
    launch those kernels (each adds one to its ``.launches`` a launch)."""
    from mic_tpu_torch.tpu import kernels, post, verify
    from mic_tpu_torch.tpu import rans_decode as rd
    from mic_tpu_torch.tpu import rans_encode as renc
    from mic_tpu_torch.tpu import scan_decode as sd
    from mic_tpu_torch.tpu import tans_decode as td

    return {
        ("direct_groups_kernel",): (rd.rans_decode_zzd, rd.rans_decode_alias,
                                    rd.rans_decode_packed, rd.rans_decode,
                                    rd.rans_decode_direct_groups),
        ("rle_groups_kernel",): (rd.rans_decode_rle, rd.rans_decode_rle_alias,
                                 rd.rans_decode_rle_groups),
        ("rans_enc_kernel",): (renc.rans_encode, renc.rans_encode_alias),
        ("tans_groups_kernel",): (td.tans_decode, td.tans_decode_groups),
        ("ycocgr_fwd_kernel",): (kernels.ycocgr_forward,),
        ("ycocgr_inv_kernel",): (kernels.ycocgr_inverse,),
        ("wt53_fwd_kernel",): (kernels.wt53_rows_forward,),
        ("wt53_inv_kernel",): (kernels.wt53_rows_inverse,),
        ("lanes_groups_kernel", "lanes_wide_kernel"): (sd.rans_decode_lanes,
                                                       sd.rans_decode_lanes_groups),
        ("mismatch_groups_kernel",): (verify.count_mismatches,),
        (POST_KERNEL,): (post.post_decode_groups,),
    }


def _finish_cupti_teardown() -> None:
    """CUDA calls that let kineto's finalise of CUPTI, requested at the
    end of a profiler session under ``TEARDOWN_CUPTI=1``, complete before
    the next session starts (a finalise that lands inside a session takes
    its records) or the process exits (it would hang there)."""
    import torch

    for _ in range(TEARDOWN_SYNCS):
        torch.cuda.synchronize()
        time.sleep(0.001)


def _profiled(fn, records: list | None = None):
    """Run ``fn()`` under torch.profiler; returns (result, wall ms, device
    ms by kernel name, device span ms).  The trace must hold one record
    of each launch the port's wrappers counted during ``fn()`` (their
    ``.launches``), kernel by kernel: a missing or extra record raises.
    Kineto drops every device record whose timestamp falls outside its
    session, and while CUPTI stays initialised from one session to the
    next the device timestamps of a process older than a minute come
    out shifted by up to milliseconds: a short window then loses its
    first records or all of them (``scripts/profiler_records.py``).  So
    kineto finalises CUPTI after each session (``TEARDOWN_CUPTI=1``) and
    the next one initialises it afresh (``_finish_cupti_teardown``).
    ``records``, when a list, receives (name, start us from the first,
    duration us) per device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.environ["TEARDOWN_CUPTI"] = "1"
    port = _port_kernels()
    before = {k: sum(w.launches for w in ws) for k, ws in port.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    _finish_cupti_teardown()
    counts = {}
    for names, ws in port.items():
        launched = sum(w.launches for w in ws) - before[names]
        held = sum(1 for e in events if any(n in e.name for n in names))
        if launched or held:
            counts[names[0]] = (launched, held)
    print(f"profile records: port launches and their trace records {counts}")
    lost = {k: v for k, v in counts.items() if v[0] != v[1]}
    if lost:
        raise AssertionError(f"torch.profiler's trace does not hold one record a port launch "
                             f"(kernel: launches, records): {lost}")
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
    busy = sum(by_name.values())
    print(f"profile: one plan.run(): wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
          f"device_span_ms={span:.3f} idle_share_of_span={1 - busy / span:.3f} "
          f"device_kernel_names={len(by_name)}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile: {ms:8.3f} ms {100 * ms / busy:5.1f}%  {name[:110]}")


def _launches(packing) -> str:
    """A direct-kernel packing's launch: blocks, shared memory a block and
    blocks resident an SM (the CUDA occupancy query)."""
    from mic_tpu_torch._build import kernel_library

    smem = packing.smem_bytes
    return (f"launch: {len(packing.blocks)} blocks, {smem} bytes of shared memory a block, "
            f"{kernel_library().mic_direct_occupancy(smem)} blocks an SM")


def _max_abs_err(got, want) -> int:
    """Largest difference of the bit-view values over all outputs."""
    import torch

    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def _kernel_split(by_name) -> tuple[float, float]:
    """(entropy kernels' ms, the post kernel's ms) of a profile's device
    time by kernel name."""
    post = sum(v for k, v in by_name.items() if POST_KERNEL in k)
    ent = sum(v for k, v in by_name.items()
              if POST_KERNEL not in k and any(e in k for e in ENTROPY_KERNELS))
    return ent, post


def _account(r, name, inputs, outputs, ms, plain_ms) -> None:
    """Adds one timed kernel call to its report entry: milliseconds, and
    the bytes and operations its bound is computed from."""
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    r["bytes"] += sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    r["ops"] += OPS_PER_ELEMENT[name] * sum(t.numel() for t in outputs)


def _encode_operands(dev, alias: bool, reps: int = 128):
    """Phase 2's encode operands: CT_dev's candidate streams under
    ``micw_compress_device_many`` (auto-fast; standard, or alias for the FF
    41 form), one image's operands replicated ``reps`` times.  Returns the
    staged batch, its operands on ``dev`` and its per-stream table widths
    (the main path's ``widths``)."""
    import numpy as np
    import torch

    from mic_tpu_torch.tpu import rans_encode as renc
    from mic_tpu_torch.tpu.strips import ALIAS_TABLE_LOG, MAX_TABLE_LOG, micw_parse

    blob = (TESTDATA / "CT_dev.micw").read_bytes()
    w, h, _ns, _sh, mv = micw_parse(blob)[:5]
    px = np.fromfile(TESTDATA / "CT_dev.raw", dtype="<u2")
    plan = renc.MicwEncodePlan([(px, w, h, mv)], "alias" if alias else "standard", "auto-fast")
    staged = renc.stage_encode_batch(
        [j[0] for j in plan.jobs[alias]], on_error="none", alias=alias,
        max_table_log=ALIAS_TABLE_LOG if alias else MAX_TABLE_LOG)
    staged.ops = tuple(np.ascontiguousarray(np.tile(a, (reps,) + (1,) * (a.ndim - 1)))
                       for a in staged.ops)
    staged.widths = np.tile(staged.widths, reps)
    return (staged, renc.staged_to_device(staged, dev),
            torch.from_numpy(staged.widths).to(dev))


def _encode_kernels_vs_plain(dev, report) -> None:
    """Phase 2, encode half: both forms of the encode kernel against their
    plain versions on CT_dev x128's candidate operands, with the per-stream
    table widths the main path passes; ns a step of the launch, shared
    memory a block, blocks an SM and waves of the card's SMs."""
    import torch

    from mic_tpu_torch.tpu import rans_encode as renc

    reps = 128
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for alias, name in ((False, "rans_encode"), (True, "rans_encode_alias")):
        staged, ops, widths = _encode_operands(dev, alias, reps)
        kernel = getattr(renc, name)
        plain = getattr(renc, name + "_plain")
        got = kernel(*ops, steps=staged.steps, widths=widths)
        want = plain(*ops, steps=staged.steps, widths=widths)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if not all(torch.equal(g, x) for g, x in zip(got, want)):
            raise AssertionError(f"{name}: kernel != plain (max abs err {err})")
        ms = _cuda_ms(lambda: kernel(*ops, steps=staged.steps, widths=widths), 10)
        plain_ms = _cuda_ms(lambda: plain(*ops, steps=staged.steps, widths=widths), 1)
        report[name]["max_abs_err"] = err
        _account(report[name], name, ops, got, ms, plain_ms)
        S, aw = ops[1].shape
        smem, per_sm, threads = renc._launch_shape(aw, alias)
        print(f"kernel-vs-plain {name} CT_dev{'_alias' if alias else ''}x{reps} "
              f"streams={S} steps={staged.steps} table_width={aw} "
              f"(own widths {int(widths.min())}-{int(widths.max())}) equal=True "
              f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}; {ms * 1e6 / staged.steps:.1f} ns a "
              f"step of the launch, {smem} bytes of shared memory a block of {threads} "
              f"threads, {per_sm} blocks an SM, {S / (per_sm * sms):.2f} waves of {sms} SMs")


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
    """Phase 2, r-mode half: the r-kernel against its plain versions on
    every bucket of phase 5's batch, each bucket alone through its wrapper
    with its own ``dense`` (timed: the wrapper call, its descriptor packing
    included) and with the other one, then all buckets in the plan's one
    launch (``rans_decode_rle_groups`` with the plan's packing, timed)."""
    import torch

    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch.tpu import rans_decode as rd

    plain = {rd.rans_decode_rle: rd.rans_decode_rle_plain,
             rd.rans_decode_rle_alias: rd.rans_decode_rle_alias_plain}
    plan = MicwDecodePlan(_r_batch()[0], dev)
    wants, plain_total = [], 0.0
    for key in plan._rle_keys:
        b = plan.buckets[key]
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
                plain_total += plain_ms
                wants.append(want)
                _account(r, name, b.ops, (got,), ms, plain_ms)
                line += f" kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}"
            print(line)
    name = "rans_decode_rle_groups"
    groups, packing = plan._rle_groups, plan.rle_packing
    got = rd.rans_decode_rle_groups(groups, packing)
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int32) - w.to(torch.int32)).abs().max()) for g, w in zip(got, wants))
    if not all(torch.equal(g, w) for g, w in zip(got, wants)):
        raise AssertionError(f"{name}: merged kernel != plain (max abs err {err})")
    ms = _cuda_ms(lambda: rd.rans_decode_rle_groups(groups, packing), 10)
    r = report[name]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    for (fn, ops, _kw), g in zip(groups, got):  # bytes and operations of each bucket's front end
        _account(r, fn.__name__, ops, (g,), 0.0, 0.0)
    r["ms"] += ms
    r["plain_ms"] += plain_total
    print(f"kernel-vs-plain {name} {len(groups)} r-buckets, {len(packing.blocks)} strips in one "
          f"launch: equal=True kernel_ms={ms:.3f} plain_ms={plain_total:.3f} (the buckets' plain "
          f"calls above); descriptors {packing.desc.nbytes} bytes, shared memory "
          f"{4 * (packing.tab_words + packing.st_words + 512)} bytes a block")
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
    t0 = time.perf_counter()
    plan = MicwDecodePlan(batch, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    merged = rd.rans_decode_rle_groups
    merged.launches = 0
    merged.family_launches = dict.fromkeys(merged.family_launches, 0)
    t0 = time.perf_counter()
    decoded = plan.run()
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    # rows 4 and 5 count the merged launches that held their front end
    launches = {"rans_decode_rle_groups": merged.launches, **merged.family_launches}
    print(f"r-mode path: {merged.launches} r-kernel launch(es) per plan.run() for "
          f"{len(plan._rle_keys)} r-buckets (design: {RLE_LAUNCHES_PER_RUN}); per front end "
          f"{merged.family_launches}")
    if merged.launches != RLE_LAUNCHES_PER_RUN:
        raise AssertionError(f"the r-mode path made {merged.launches} r-kernel launches in one "
                             f"plan.run(), the design makes {RLE_LAUNCHES_PER_RUN}")
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
    last = {}
    run_ms = _cuda_ms(lambda: last.update(out=plan.run()), 5)
    timed_mism = plan.verify_batch(last["out"], expected)
    print(f"r-mode path: {run_ms:.3f} ms per plan.run(), "
          f"{timed_bytes / (run_ms / 1e3) / 1e9:.3f} GB/s of decoded u16 pixels "
          f"({timed_bytes} bytes); the last timed run: mismatches={timed_mism}, "
          f"{merged.launches} r-kernel launches in {1 + 6} runs")
    if timed_mism or merged.launches != 7 * RLE_LAUNCHES_PER_RUN:
        raise AssertionError(f"timed r-mode runs: {timed_mism} mismatches, "
                             f"{merged.launches} launches")
    del last
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


def _post_kernels_vs_plain(dev, report, blobs) -> None:
    """Phase 2, post half: the symbols-out front ends through their
    one-bucket wrappers against their plain versions on every post bucket
    of phase 6's batch and of CT_dev_1strip_tl15 x32, then each plan's
    merged launch against its plain twin."""
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
                line += f" tl={tl} " + _launches(rd._bucket_packing(b.fn, b.ops, b.kwargs))
                by_tl.setdefault(tl, [0, 0.0])
                by_tl[tl][0] += b.n
                by_tl[tl][1] += ms
            print(line)
        # The plan's merged launch (not counted: the packing is the plan's);
        # the tl 15 plan's once more with its tables read from device
        # memory, as tl 16 reads them.
        groups = plan._direct_groups
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = rd.rans_decode_direct_groups_plain(groups)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        packings = [("", plan.direct_packing)]
        if tag.startswith("CT_dev_1strip_tl15"):
            packings.append((" tables from device memory",
                             rd._tables_from_memory(rd.DirectPacking(groups))))
        for form, packing in packings:
            got = rd._direct_launch(packing)
            torch.cuda.synchronize()
            err = _max_abs_err(got, want)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"merged launch {tag}{form}: kernel != plain "
                                     f"(max abs err {err})")
            ms = _cuda_ms(lambda: rd._direct_launch(packing), 10)
            print(f"kernel-vs-plain merged launch {tag}{form}: {len(groups)} groups "
                  f"({sum(ops[0].shape[0] for _f, ops, _k in groups)} strips; front ends "
                  f"{packing.families}) equal=True kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}; "
                  f"{_launches(packing)}")
            del got
        del want
    for tl, (n, ms) in sorted(by_tl.items()):
        print(f"two-table front end at tl {tl}: {n} strips, {ms:.3f} ms over its buckets' "
              f"wrapper calls")
    del plans


def _entropy_outputs(plan) -> dict:
    """A plan's entropy launches alone (direct and lanes kernels, with its
    packings): {bucket key: output} for its post stage."""
    from mic_tpu_torch.tpu import rans_decode as rd
    from mic_tpu_torch.tpu import scan_decode as sd

    outs = dict(zip(plan._direct_keys, rd.rans_decode_direct_groups(plan._direct_groups,
                                                                    plan.direct_packing)))
    outs.update(zip(plan._scan_keys, sd.rans_decode_lanes_groups(plan._scan_groups,
                                                                 plan.scan_packing)))
    return outs


def _flipped_groups(groups, n: int, seed: int):
    """Post groups whose entropy outputs are copies with ``n`` symbols each
    XORed with a random nonzero 16-bit word (damaged streams)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for ent, meta, kw in groups:
        bad = ent.clone()
        flat = bad.view(-1)
        at = torch.from_numpy(rng.integers(0, flat.numel(), n)).to(flat.device)
        word = rng.integers(1, 1 << 16, n).astype(np.uint16).view(np.int16)
        flat[at] ^= torch.from_numpy(word).to(flat.device)
        out.append((bad, meta, kw))
    return out


def _post_stage_vs_plain(dev, report, post_blobs) -> None:
    """Phase 2, post stage: ``csrc/post.cu`` (one launch of
    ``post_decode_groups`` with the plan's packing) against its plain twin
    ``post_batch`` on every post bucket of phase 6's batch, phase 8's tile
    batch and CT_dev_1strip_tl15 x32, on the entropy launch's symbols and
    on a copy with ``POST_FLIPS`` symbols a bucket flipped; the report
    takes phase 6's and phase 8's clean launches."""
    import torch

    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch.tpu import post, rgb_device

    name = "post_decode_groups"
    tiles = [(TESTDATA / "tissue_dev.mwr3").read_bytes()] * 64
    plans = [("phase-6-batch", MicwDecodePlan(post_blobs, dev)),
             ("phase-8-tile-batch", rgb_device._stage(tiles, dev)[1]),
             ("CT_dev_1strip_tl15x32", MicwDecodePlan([CT_TL15.read_bytes()] * 32, dev))]
    r = report[name]
    for seed, (tag, plan) in enumerate(plans):
        pk = plan.post_packing
        outs = _entropy_outputs(plan)
        clean = [(outs[k], *g) for k, g in zip(plan._post_keys, plan._post_groups)]
        kinds: dict[str, int] = {}
        for _e, meta, kw in clean:
            kinds[kw["predictor"]] = kinds.get(kw["predictor"], 0) + meta.shape[0]
        for form, groups in (("clean", clean), ("flipped", _flipped_groups(clean, POST_FLIPS,
                                                                           19 + seed))):
            got = post.post_decode_groups(groups, pk)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            want = [post.post_batch(e, m[:, 0], m[:, 1], m[:, 2], **kw) for e, m, kw in groups]
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            err = _max_abs_err(got, want)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} {tag} {form}: kernel != post_batch "
                                     f"(max abs err {err})")
            ms = _cuda_ms(lambda: post.post_decode_groups(groups, pk), 10)
            inputs = [t for e, m, _kw in groups for t in (e, m)]
            n_bytes = sum(t.numel() * t.element_size() for t in (*inputs, *got))
            pixels = sum(o.numel() for o in got)
            bound_ms = max(n_bytes / MEM_BPS, OPS_PER_ELEMENT[name] * pixels / CORE_OPS) * 1e3
            print(f"kernel-vs-plain {name} {tag} {form}: {len(groups)} buckets, "
                  f"{len(pk.blocks)} blocks of one strip {kinds}, {len(pk.parts)} launch(es); "
                  f"equal=True max_abs_err={err} "
                  f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} "
                  f"({n_bytes} bytes, {pixels} pixels)")
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if form == "clean" and tag != "CT_dev_1strip_tl15x32":
                _account(r, name, inputs, got, ms, plain_ms)
            del got, want
        if tag != "CT_dev_1strip_tl15x32":  # each bucket alone: where the launch's time goes
            for e, m, kw in clean:
                one = [(e, m, kw)]
                one_pk = post.PostPacking([(m, kw)], dev)
                ms = _cuda_ms(lambda: post.post_decode_groups(one, one_pk), 5)
                print(f"post kernel {tag} bucket alone: {kw['predictor']} {m.shape[0]} strips of "
                      f"{kw['width']}x{kw['strip_h']} (max_tokens {kw['max_tokens']}, "
                      f"max_runs {kw['max_runs']}) kernel_ms={ms:.3f}")
        del outs, clean
    smem, per_sm, regs = post._launch_shape()
    print(f"post kernel launch shape: {smem} bytes of shared memory a block, {per_sm} blocks an "
          f"SM, {regs} registers a thread (a block a strip)")
    del plans


def _post_phase(dev, blobs, expected, names):
    """Phase 6: the post-path decode; returns the run's launch counts."""
    import numpy as np
    import torch

    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch.tpu import post
    from mic_tpu_torch.tpu import rans_decode as rd

    timed_bytes = _entropy_bytes(blobs)
    t0 = time.perf_counter()
    plan = MicwDecodePlan(blobs, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    merged = rd.rans_decode_direct_groups
    merged.launches = 0
    merged.family_launches = dict.fromkeys(merged.family_launches, 0)
    post.post_decode_groups.launches = 0
    post.post_batch.calls = 0
    t0 = time.perf_counter()
    decoded = plan.run()
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    # rows 6 and 7 count the merged launches that held their front end
    launches = {"rans_decode_direct_groups": merged.launches, **merged.family_launches,
                "post_decode_groups": post.post_decode_groups.launches}
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
    post_keys = [k for k in plan.buckets if k[0] == "post"]
    print(f"post path: {launches['rans_decode_direct_groups']} direct-kernel launch(es) per "
          f"plan.run() for {len(plan._direct_keys)} groups ({len(post_keys)} post buckets; "
          f"design: {DIRECT_LAUNCHES_PER_RUN}); {_launches(plan.direct_packing)}")
    if (launches["rans_decode_direct_groups"] != DIRECT_LAUNCHES_PER_RUN
            or any(launches[n] != DIRECT_LAUNCHES_PER_RUN for n in POST_FRONT_ENDS)
            or not set(post_keys) <= set(plan._direct_keys)):
        raise AssertionError(f"the post path's entropy stage is not the plan's one launch: "
                             f"{launches}")
    pk = plan.post_packing
    print(f"post path: {launches['post_decode_groups']} post-kernel launch(es) per plan.run() "
          f"for {len(plan._post_keys)} post buckets (design: {POST_LAUNCHES_PER_RUN}), "
          f"{len(pk.blocks)} blocks of one strip; {post.post_batch.calls} post_batch calls")
    if (launches["post_decode_groups"] != POST_LAUNCHES_PER_RUN or post.post_batch.calls
            or set(plan._post_keys) != set(post_keys)):
        raise AssertionError(f"the post stage is not the plan's one post-kernel launch: "
                             f"{launches}, {post.post_batch.calls} post_batch calls")
    run_ms = _cuda_ms(plan.run, 3)
    print(f"post path: {run_ms:.3f} ms per plan.run(), "
          f"{timed_bytes / (run_ms / 1e3) / 1e9:.3f} GB/s of decoded u16 pixels "
          f"({timed_bytes} bytes); {post.post_decode_groups.launches} post-kernel launches and "
          f"{post.post_batch.calls} post_batch calls in 5 runs")
    if post.post_decode_groups.launches != 5 * POST_LAUNCHES_PER_RUN or post.post_batch.calls:
        raise AssertionError("timed post-path runs: not one post-kernel launch a run")
    _out, wall_ms, by_name, span = _profiled(plan.run)
    busy = sum(by_name.values())
    ent, post_ms = _kernel_split(by_name)
    print(f"profile: one plan.run(): wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
          f"device_span_ms={span:.3f} idle_share_of_span={1 - busy / span:.3f} "
          f"entropy_kernels_ms={ent:.3f} ({100 * ent / busy:.1f}% of busy) "
          f"post_kernel_ms={post_ms:.3f} ({100 * post_ms / busy:.1f}% of busy) "
          f"other_ops_ms={busy - ent - post_ms:.3f} device_kernel_names={len(by_name)}")
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


def _tans_alone(plan):
    """Each group of a TansDecodePlan as a launch of its own: (packing of
    the one group, steps of its longest chain)."""
    from mic_tpu_torch.tpu import tans_decode as td

    return [(td.TansPacking([group]), max(-(-c // kw["n_states"]) for c in counts))
            for group, (_idx, counts, _ops, kw) in zip(plan._launch_groups, plan.groups)]


def _tans_kernels_vs_plain(dev, report) -> None:
    """Phase 2, tANS half: the kernel against its plain version on phase
    7's batch: all groups in one launch (``tans_decode_groups``, what the
    plan runs, timed for the report) and every group alone through
    ``tans_decode``, with each stream's own sizes and with the launch's
    widths.  The bound counts what the groups' streams need (their bits,
    tables and symbols), not the padded operands."""
    import torch

    from mic_tpu_torch.tpu import tans_decode as td

    batch, _host, work = _ref_batch()
    plan = td.TansDecodePlan(batch, dev)
    groups = plan._launch_groups
    r = report["tans_decode"]
    got = td.tans_decode_groups(groups, plan.packing)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = td.tans_decode_groups_plain(groups)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    mixed = 0
    for (idx, counts, ops, kw), sizes, g, w in zip(plan.groups, plan.sizes, got, want):
        own = td.tans_decode(*ops, sizes=sizes, **kw)
        wide = td.tans_decode(*ops, **kw)
        torch.cuda.synchronize()
        err = max(int((k.to(torch.int32) - w.to(torch.int32)).abs().max()) for k in (g, own, wide))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if not (torch.equal(g, w) and torch.equal(own, w) and torch.equal(wide, w)):
            raise AssertionError(f"tans_decode {kw}: kernel != plain (max abs err {err}; merged "
                                 f"{torch.equal(g, w)}, alone with sizes {torch.equal(own, w)}, "
                                 f"alone without {torch.equal(wide, w)})")
        tables = sorted(set(sizes[:, 0].tolist()))
        mixed += len(tables) > 1
        r["bytes"] += sum(work[i] for i in idx)
        r["ops"] += OPS_PER_ELEMENT["tans_decode"] * sum(counts)
        print(f"kernel-vs-plain tans_decode group N={kw['n_states']} streams={len(idx)} "
              f"steps={kw['steps']} table_log={kw['table_log']} own_table_words={tables} "
              f"alphabet_width={ops[4].shape[1]} symbols={sum(counts)} "
              f"equal=True (merged, alone with sizes, alone without)")
    if not mixed:
        raise AssertionError("no group of the batch mixes tableLogs")
    ms = _cuda_ms(lambda: td.tans_decode_groups(groups, plan.packing), 10)
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    print(f"kernel-vs-plain tans_decode_groups {len(groups)} groups, {plan.stats['kernel']} "
          f"streams in one launch: equal=True kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
          f"(one call); blocks={len(plan.packing.blocks)} x {plan.packing.warps} warps, "
          f"pool={plan.packing.pool_bytes} bytes")
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
    from mic_tpu_torch.tpu.tans_decode import tans_decode_groups
    from mic_tpu_torch.utils.io import read_mic1

    def raw(name, dtype="<u2"):
        return np.fromfile(TESTDATA / f"{name}.raw", dtype=dtype)

    def check(what, ok):
        print(f"entry point {what}: equal={ok}")
        if not ok:
            raise AssertionError(f"{what} decoded wrong pixels")

    def counted(what, fn, wrappers=(tans_decode_groups,)):
        return _counted(what, fn, wrappers)[0]

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
                   (tans_decode_groups, renc.rans_encode))
    total_s = time.perf_counter() - t0
    decoded = counted("ingest_plan's MicwDecodePlan.run", plan.run,
                      (rd.rans_decode_direct_groups,))
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
    from mic_tpu_torch._build import kernel_library
    from mic_tpu_torch.ops.fse_codec import fse_decompress_auto
    from mic_tpu_torch.tpu import tans_decode as td

    batch, host, _work = _ref_batch()
    td.tans_decode_groups.launches = 0
    stats = {}
    t0 = time.perf_counter()
    syms = fse_decompress_device_batch(batch, dev, stats=stats)
    call_s = time.perf_counter() - t0
    launches = td.tans_decode_groups.launches
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
    if launches != 1 or stats["launches"] != 1:
        raise AssertionError(f"the reference path made {launches} launches for its one run "
                             f"(stats: {stats['launches']}), expected 1")
    del syms

    t0 = time.perf_counter()
    plan = td.TansDecodePlan(batch, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    before = td.tans_decode_groups.launches
    plan.run()
    if td.tans_decode_groups.launches != before + 1:
        raise AssertionError("TansDecodePlan.run() is not one launch")
    run_ms = _cuda_ms(plan.run, 5)
    sym_bytes = 2 * plan.stats["symbols"]
    print(f"reference path: {run_ms:.3f} ms per plan.run(), "
          f"{sym_bytes / (run_ms / 1e3) / 1e9:.3f} GB/s of u16 symbols ({sym_bytes} bytes, "
          f"{plan.stats['kernel']} kernel streams of {plan.stats['groups']} groups in "
          f"{plan.stats['launches']} launch), stage_s={stage_s:.3f}")
    # The launch's shape, and each group alone (a launch of its own, the
    # pool chosen for it): what the one launch saves over their sum.
    packing = plan.packing
    lib = kernel_library()
    per_sm = lib.mic_tans_occupancy(packing.warps, packing.pool_bytes)
    if per_sm < 1:
        raise AssertionError(f"occupancy query failed or 0 blocks fit: {per_sm}")
    held = [len(b[1]) for b in packing.blocks]
    print(f"reference path launch: {len(held)} blocks of {packing.warps} warps, pool "
          f"{packing.pool_bytes} bytes, {min(held)}-{max(held)} streams a block (mean "
          f"{sum(held) / len(held):.2f}); cudaOccupancyMaxActiveBlocksPerMultiprocessor="
          f"{per_sm}; tableLog histogram of the kernel streams {plan.stats['table_logs']}")
    alone, alone_ms = _tans_alone(plan), 0.0
    for (p1, chain), (idx, _counts, _ops, kw) in zip(alone, plan.groups):
        ms = _cuda_ms(lambda: td.tans_decode_groups(p1.groups, p1), 3)
        alone_ms += ms
        print(f"reference path group alone N={kw['n_states']} streams={len(idx)} "
              f"steps={kw['steps']}: {ms:.3f} ms, {ms * 1e6 / chain:.1f} ns per step of its "
              f"longest chain ({chain} steps); pool {p1.pool_bytes} bytes, "
              f"{len(p1.blocks)} blocks")
    longest = max(chain for _p, chain in alone)
    print(f"reference path: one launch {run_ms:.3f} ms against {alone_ms:.3f} ms for the "
          f"groups alone, one after another; {run_ms * 1e6 / longest:.1f} ns per step of the "
          f"longest chain ({longest} steps)")
    # torch.profiler's view of one run (its record of the launch checked)
    records = []
    _out, wall_ms, by_name, span = _profiled(plan.run, records)
    busy = sum(by_name.values())
    print(f"profile: one plan.run(): wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
          f"device_span_ms={span:.3f} idle_share_of_span={1 - busy / span:.3f}")
    for name, t_us, dur_us in records:
        print(f"profile record: {name[:60]} start_us={t_us:.3f} dur_us={dur_us:.3f}")
    del plan, _out
    _ref_entry_points(dev)
    return {"tans_decode": launches}


def _slide():
    """Phase 8's slide: (interleaved RGB uint8 [height, width, 3], width,
    height).  8x8 copies of tissue_dev.raw, alternate copies mirrored,
    inside a constant white margin of one tile."""
    import numpy as np

    t = np.fromfile(TESTDATA / "tissue_dev.raw", np.uint8).reshape(384, 512, 3)
    rows = [np.concatenate([t if (i + j) % 2 == 0 else t[:, ::-1] for j in range(8)], axis=1)
            for i in range(8)]
    body = np.concatenate(rows, axis=0)
    slide = np.full((body.shape[0] + 2 * TILE, body.shape[1] + 2 * TILE, 3), 255, np.uint8)
    slide[TILE:-TILE, TILE:-TILE] = body
    return slide, slide.shape[1], slide.shape[0]


def _transform_kernels_vs_plain(dev, report, slide) -> None:
    """Phase 2, transform half: the four kernels of csrc/transforms.cu
    against their plain versions."""
    import numpy as np
    import torch

    from mic_tpu_torch.tpu import kernels as K

    rng = np.random.default_rng(6)
    n = slide.shape[0] * slide.shape[1]
    rand = [torch.from_numpy(rng.integers(0, 65536, n).astype(np.uint16).view(np.int16)).to(dev)
            for _ in range(3)]
    px = torch.from_numpy(slide).to(dev).view(-1, 3).to(torch.int16)
    rgb = [px[:, c].contiguous() for c in range(3)]
    ycc = list(K.ycocgr_forward_plain(*rgb))
    cases = [("ycocgr_forward", "random u16", rand), ("ycocgr_forward", "slide RGB", rgb),
             ("ycocgr_inverse", "random u16", rand), ("ycocgr_inverse", "slide YCoCg", ycc)]
    for name, tag, planes in cases:
        kernel, plain = getattr(K, name), getattr(K, name + "_plain")
        got, want = kernel(*planes), plain(*planes)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} {tag}: kernel != plain (max abs err {err})")
        ms = _cuda_ms(lambda: kernel(*planes), 10)
        plain_ms = _cuda_ms(lambda: plain(*planes), 2)
        r = report[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if tag.startswith("slide"):  # the main path's planes
            _account(r, name, planes, got, ms, plain_ms)
        print(f"kernel-vs-plain {name} {tag} pixels={n} equal=True kernel_ms={ms:.3f} "
              f"plain_ms={plain_ms:.3f} GBps={12 * n / (ms / 1e3) / 1e9:.3f}")
    del rand, px, rgb, ycc
    # rows x cols: the slide's green plane, an odd crop, an even width that
    # is no multiple of 4, and the transposed slide (the column pass)
    for rows, cols in ((3584, 4608), (749, 1001), (2304, 1794), (4608, 3584)):
        x = torch.from_numpy(rng.integers(0, 65536, (rows, cols)).astype(np.int32)).to(dev)
        for name in ("wt53_rows_forward", "wt53_rows_inverse"):
            kernel, plain = getattr(K, name), getattr(K, name + "_plain")
            got, want = kernel(x), plain(x)
            torch.cuda.synchronize()
            err = _max_abs_err((got,), (want,))
            if not torch.equal(got, want):
                raise AssertionError(f"{name} {rows}x{cols}: kernel != plain (max abs err {err})")
            ms = _cuda_ms(lambda: kernel(x), 10)
            plain_ms = _cuda_ms(lambda: plain(x), 2)
            r = report[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if (rows, cols) in ((3584, 4608), (4608, 3584)):  # level 0 of phase 9's slide
                _account(r, name, (x,), (got,), ms, plain_ms)
            print(f"kernel-vs-plain {name} rows={rows} cols={cols} equal=True "
                  f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
                  f"GBps={8 * rows * cols / (ms / 1e3) / 1e9:.3f}")
        del x


def _counted(what, fn, wrappers):
    """fn() with the wrappers' launch counts set to 0 just before it;
    returns (result, {name: launches}) and fails unless each launched."""
    for w in wrappers:
        w.launches = 0
    out = fn()
    counts = {w.__name__: w.launches for w in wrappers}
    print(f"launches {what}: {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"{what} did not launch {counts}")
    return out, counts


def _flipped_copy(packing, outs, n: int):
    """``outs`` with the largest compared bucket's output replaced by a
    copy with ``n`` distinct pixels flipped (bit 0), each below its row's
    valid length; returns (outputs, the count of flipped pixels)."""
    import numpy as np
    import torch

    g = max((i for i, e in enumerate(packing.expected) if e is not None),
            key=lambda i: int(packing.expected[i][1][packing.expected[i][2].long()].sum()))
    _exp, valid, rowmap = (t.cpu().numpy() for t in packing.expected[g])
    rng = np.random.default_rng(18)
    rows = rng.integers(0, packing.rows[g], 4 * n)
    lens = valid[rowmap[rows]]
    keep = lens > 0
    cols = (rng.random(keep.sum()) * lens[keep]).astype(np.int64)
    pairs = np.unique(np.stack([rows[keep], cols], axis=1), axis=0)[:n]
    bad = outs[g].clone()
    r, c = (torch.from_numpy(a).to(bad.device) for a in pairs.T)
    bad[r, c] ^= 1
    return [bad if i == g else o for i, o in enumerate(outs)], len(pairs)


def _compare_work(packing):
    """(bytes, operations) of one compare: each compared output pixel read
    once, each distinct expected pixel below its row's valid length once,
    the valid lengths and row maps, the probe's pixels, the two totals
    written; a compare and an add a pixel."""
    n_bytes, n_px = 16 + 2 * 8 * len(packing.rows), 0
    for staged in packing.expected:
        if staged is None:
            continue
        _exp, valid, rowmap = staged
        v = int(valid[rowmap.long()].sum())
        n_px += v
        n_bytes += 2 * v + 2 * int(valid.sum()) + 4 * (valid.numel() + rowmap.numel())
    return n_bytes, 2 * n_px


def _timed_runner(what, plan, expected, timed_bytes, report) -> int:
    """The plan's timed runner (``MicwDecodePlan.make_timed_runner``):
    ``runner(1)`` must count 0 mismatching pixels; then the compare kernel
    (``verify.count_mismatches``) against its plain twin on one run's
    outputs, clean and with flips injected into a copy of one bucket's
    output (equal totals and the flips' count, or it raises), each timed
    by CUDA events; ``RUNNER_PAIRS`` turns of one ``plan.run()`` and one
    ``runner(1)``, each between its own events (runner(1) minus a run,
    medians); then ``RUNNER_BLOCKS`` turns of ``RUNNER_REPS`` runs back
    to back and ``runner(RUNNER_REPS)``, its GB/s beside theirs and beside
    the median ``plan.run()``'s.  Returns the compare kernel's launches in
    the ``runner(RUNNER_REPS)`` calls (one a run)."""
    import torch

    from mic_tpu_torch.tpu import verify

    t0 = time.perf_counter()
    runner = plan.make_timed_runner(expected)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if runner is None:
        raise AssertionError(f"{what}: make_timed_runner refused the batch (a raw strip differs)")
    first = int(runner(1)[0])
    if first:
        raise AssertionError(f"{what}: the timed runner's first run has {first} mismatches")
    packing = runner.packing
    outs = list(plan.run().values())
    flipped, n_flips = _flipped_copy(packing, outs, 1000)
    for label, o, want in (("clean", outs, 0), ("flipped", flipped, n_flips)):
        got = torch.zeros(2, dtype=torch.int64, device=plan.device)
        plain = torch.zeros(2, dtype=torch.int64, device=plan.device)
        verify.count_mismatches(packing, o, got)
        verify.count_mismatches_plain(packing, o, plain)
        got, plain = got.tolist(), plain.tolist()
        print(f"{what}: compare kernel vs plain, {label} outputs: kernel {got} plain {plain} "
              f"(mismatches, probe); {want} flipped pixels")
        if got != plain or got[0] != want:
            raise AssertionError(f"{what}: compare kernel {got} != plain {plain} or != {want} "
                                 f"mismatches ({label})")
    acc = torch.zeros(2, dtype=torch.int64, device=plan.device)
    ms = _cuda_ms(lambda: verify.count_mismatches(packing, outs, acc), 10)
    plain_ms = _cuda_ms(lambda: verify.count_mismatches_plain(packing, outs, acc), 2)
    n_bytes, n_ops = _compare_work(packing)
    r = report["count_mismatches"]
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    r["bytes"] += n_bytes
    r["ops"] += n_ops
    print(f"{what}: compare kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{n_bytes / MEM_BPS * 1e3:.3f} ms ({n_bytes} bytes; {len(packing.blocks)} compare "
          f"blocks, {len(packing.parts)} launch)")
    del outs, flipped
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(RUNNER_PAIRS)]
    for e0, e1, e2 in ev:
        e0.record()
        plan.run()
        e1.record()
        runner(1)  # one run and the compare
        e2.record()
    # RUNNER_REPS runs back to back, plain and through the runner, in turns
    # (plain first in even turns, the runner first in odd ones)
    verify.count_mismatches.launches = 0
    found, plain_ev, runner_ev = [], [], []

    def plain_runs():
        for _ in range(RUNNER_REPS):
            plan.run()

    for i in range(RUNNER_BLOCKS):
        for name in (("plain", "runner") if i % 2 == 0 else ("runner", "plain")):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            if name == "plain":
                plain_runs()
            else:
                found.append(runner(RUNNER_REPS))
            e[1].record()
            (plain_ev if name == "plain" else runner_ev).append(e)
    torch.cuda.synchronize()
    launches = verify.count_mismatches.launches
    med, bmed = RUNNER_PAIRS // 2, RUNNER_BLOCKS // 2
    run_ms = sorted(e0.elapsed_time(e1) for e0, e1, _e2 in ev)
    one_ms = sorted(e1.elapsed_time(e2) for _e0, e1, e2 in ev)
    runs_ms = sorted(e0.elapsed_time(e1) / RUNNER_REPS for e0, e1 in plain_ev)
    ms = sorted(e0.elapsed_time(e1) / RUNNER_REPS for e0, e1 in runner_ev)
    gbs, run_gbs, runs_gbs = (timed_bytes / (t / 1e3) / 1e9
                              for t in (ms[bmed], run_ms[med], runs_ms[bmed]))
    mism = [int(m) for m, _p in found]
    print(f"{what}: timed runner built in {build_s:.3f} s; runner(1) mismatches=0; "
          f"{RUNNER_PAIRS} turns by CUDA events: plan.run() {run_ms[0]:.3f} / {run_ms[med]:.3f} / "
          f"{run_ms[-1]:.3f} ms, runner(1) {one_ms[0]:.3f} / {one_ms[med]:.3f} / "
          f"{one_ms[-1]:.3f} ms (least / median / most); runner(1) minus one plan.run() "
          f"{one_ms[med] - run_ms[med]:.3f} ms (medians)")
    print(f"{what}: {RUNNER_BLOCKS} turns of {RUNNER_REPS} plan.run() back to back and "
          f"runner({RUNNER_REPS}): {runs_ms[0]:.3f} / {runs_ms[bmed]:.3f} / {runs_ms[-1]:.3f} ms "
          f"and {ms[0]:.3f} / {ms[bmed]:.3f} / {ms[-1]:.3f} ms a run (least / median / most); "
          f"runner({RUNNER_REPS}) {gbs:.3f} GB/s of decoded u16 pixels against {runs_gbs:.3f} "
          f"back to back ({100 * (gbs / runs_gbs - 1):+.2f} %) and plan.run()'s median "
          f"{run_gbs:.3f} in the turns above ({100 * (gbs / run_gbs - 1):+.2f} %); "
          f"mismatches={mism} probe={int(found[0][1])}; compare launches {launches}")
    if any(mism):
        raise AssertionError(f"{what}: runner({RUNNER_REPS}) counted {mism} mismatches")
    if launches != RUNNER_BLOCKS * RUNNER_REPS * len(packing.parts):
        raise AssertionError(f"{what}: {RUNNER_BLOCKS} runner({RUNNER_REPS}) calls made {launches} "
                             f"compare launches, expected one a run")
    return launches


def _timed_rgb_decode(what, blobs, dev, n_bytes) -> None:
    """Stage a batch of MWR3 blobs once, then time the device part of
    ``micwr_decode_many`` (entropy launches, assemble, crop, YCoCg-R
    inverse, interleave) with CUDA events and split it with the profiler."""
    import torch

    from mic_tpu_torch.tpu import rgb_device

    t0 = time.perf_counter()
    metas, plan = rgb_device._stage(blobs, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    ms = _cuda_ms(lambda: rgb_device._run(metas, plan), 5)
    n_strips = sum(b.n for b in plan.buckets.values())
    print(f"{what}: {len(blobs)} MWR3 blobs, {n_strips} entropy strips in "
          f"{len(plan.buckets)} buckets, stage_s={stage_s:.3f}, {ms:.3f} ms per decode "
          f"(staged; CUDA events), {n_bytes / (ms / 1e3) / 1e9:.3f} GB/s of RGB bytes out "
          f"({n_bytes} bytes)")
    _out, wall_ms, by_name, span = _profiled(lambda: rgb_device._run(metas, plan))
    busy = sum(by_name.values())
    ent, post_ms = _kernel_split(by_name)
    ycc = sum(v for k, v in by_name.items() if "ycocgr" in k)
    print(f"profile {what}: wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
          f"device_span_ms={span:.3f} idle_share_of_span={1 - busy / span:.3f} "
          f"entropy_kernels_ms={ent:.3f} post_kernel_ms={post_ms:.3f} "
          f"ycocgr_kernel_ms={ycc:.3f} "
          f"assemble_and_other_torch_ops_ms={busy - ent - post_ms - ycc:.3f} "
          f"device_kernel_names={len(by_name)}")
    for name, kms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"profile: {kms:8.3f} ms {100 * kms / busy:5.1f}%  {name[:110]}")


def _rgb_wsi_phase(dev, slide):
    """Phase 8: the W3D1 slide, the MWR3 tile batch and the device MIC2
    fixtures; returns the launch counts of the YCoCg-R wrappers."""
    import numpy as np
    import torch

    from mic_tpu_torch import (
        compress_multi_frame_device,
        decompress_multi_frame_device,
        micwr_compress,
        micwr_decode_many,
        w3d_compress,
        w3d_decompress_level,
        w3d_decompress_region,
        w3d_header,
    )
    from mic_tpu_torch.ops.pyramid import downsample2x_rgb
    from mic_tpu_torch.tpu import kernels as K
    from mic_tpu_torch.tpu import post
    from mic_tpu_torch.tpu import rans_decode as rd
    from mic_tpu_torch.tpu import rans_encode as renc
    from mic_tpu_torch.tpu import rgb_device, wsi_device

    total = {"ycocgr_forward": 0, "ycocgr_inverse": 0}

    def add(counts):
        for k in total:
            total[k] += counts.get(k, 0)

    def check(what, ok):
        print(f"rgb/wsi {what}: equal={ok}")
        if not ok:
            raise AssertionError(f"{what}: wrong bytes")

    # --- the slide: ingest ------------------------------------------------
    rgb, width, height = slide.reshape(-1), slide.shape[1], slide.shape[0]
    t0 = time.perf_counter()
    blob, counts = _counted(
        "w3d_compress",
        lambda: w3d_compress(rgb, width, height, dev, tile_w=TILE, tile_h=TILE,
                             device_encode=True),
        (K.ycocgr_forward, renc.rans_encode))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    add(counts)
    # The split, from a second run of the tiling and the transform alone.
    t0 = time.perf_counter()
    _n_levels, tiles = wsi_device._tiles(rgb, width, height, TILE, TILE, 0)
    tiles_s = time.perf_counter() - t0
    rgbs = [(t[4], TILE, TILE) for t in tiles if t[3] == wsi_device.TILE_MWR3]
    t0 = time.perf_counter()
    planes = rgb_device._forward_planes(rgbs, dev)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    (w, h, _tw, _th, levels), entries, _off = w3d_header(blob)
    n_const = sum(1 for e in entries if e[3] == wsi_device.TILE_CONST)
    lvl0 = [e for e in entries if e[0] == 0]
    plane_bytes = 2 * 3 * TILE * TILE * len(rgbs)
    print(f"rgb/wsi slide {w}x{h}: {len(rgb)} RGB bytes -> {len(blob)} bytes W3D1 "
          f"(ratio {len(rgb) / len(blob):.3f}), {levels} levels, {len(entries)} tiles "
          f"({n_const} constant; level 0: {len(lvl0)}, "
          f"{sum(1 for e in lvl0 if e[3] == wsi_device.TILE_CONST)} constant), "
          f"{3 * len(rgbs)} planes = {plane_bytes} bytes of u16 encoded; "
          f"w3d_compress total_s={total_s:.3f}; separate runs: tiling_s={tiles_s:.3f} "
          f"forward_transform_s={forward_s:.3f} (upload, kernel, download); "
          f"encode_call_s={total_s - tiles_s - forward_s:.3f} (by subtraction: plane padding, "
          f"micw_compress_device_many, container); "
          f"MBps={len(rgb) / total_s / 1e6:.3f} of RGB bytes in")
    del planes, rgbs, tiles

    # --- the slide: tile server --------------------------------------------
    decode_fns = (K.ycocgr_inverse, rd.rans_decode_direct_groups)
    (got, gw, gh), counts = _counted("w3d_decompress_level 0",
                                     lambda: w3d_decompress_level(blob, dev, 0), decode_fns)
    add(counts)
    check(f"w3d_decompress_level 0 ({gw}x{gh})", (gw, gh) == (width, height)
          and np.array_equal(got, rgb))
    want1, w1, h1 = downsample2x_rgb(rgb, width, height)
    (got, gw, gh), counts = _counted("w3d_decompress_level 1",
                                     lambda: w3d_decompress_level(blob, dev, 1), decode_fns)
    add(counts)
    check(f"w3d_decompress_level 1 ({gw}x{gh}) vs downsample2x_rgb", (gw, gh) == (w1, h1)
          and np.array_equal(got, want1))
    x, y, rw, rh = 200, 180, 700, 600  # tile (0, 0) is the constant margin
    (got, gw, gh), counts = _counted(
        "w3d_decompress_region", lambda: w3d_decompress_region(blob, x, y, rw, rh, dev),
        decode_fns)
    add(counts)
    check(f"w3d_decompress_region x={x} y={y} {rw}x{rh}", (gw, gh) == (rw, rh)
          and np.array_equal(got.reshape(rh, rw, 3), slide[y : y + rh, x : x + rw]))
    data_off = 28 + 24 * len(entries)
    mwr = [blob[data_off + e[4] : data_off + e[4] + e[5]] for e in lvl0
           if e[3] == wsi_device.TILE_MWR3]
    _timed_rgb_decode("rgb/wsi level-0 decode", mwr, dev, 3 * TILE * TILE * len(mwr))
    del mwr, blob

    # --- MWR3 tile batch: the auto fixture and an auto-r container ----------
    fixture = (TESTDATA / "tissue_dev.mwr3").read_bytes()
    tissue = np.fromfile(TESTDATA / "tissue_dev.raw", np.uint8)
    made, counts = _counted("micwr_compress auto", lambda: micwr_compress(tissue, 512, 384, dev),
                            (K.ycocgr_forward, renc.rans_encode))
    add(counts)
    check("micwr_compress(tissue_dev.raw) vs tissue_dev.mwr3", made == fixture)
    auto_r, counts = _counted(
        "micwr_compress auto-r", lambda: micwr_compress(tissue, 512, 384, dev, predictor="auto-r"),
        (K.ycocgr_forward, renc.rans_encode))
    add(counts)
    batch = [fixture] * 64 + [auto_r] * 64
    t0 = time.perf_counter()
    outs, counts = _counted("micwr_decode_many", lambda: micwr_decode_many(batch, dev),
                            (K.ycocgr_inverse, rd.rans_decode_direct_groups,
                             rd.rans_decode_rle_groups, post.post_decode_groups))
    call_s = time.perf_counter() - t0
    add(counts)
    check(f"micwr_decode_many tissue_dev.mwr3 x64 + auto-r x64 ({call_s:.3f} s, staging included)",
          all((w, h) == (512, 384) and np.array_equal(o, tissue) for o, w, h in outs))
    del outs
    _timed_rgb_decode("rgb/wsi tile batch decode", batch, dev, tissue.size * len(batch))

    # --- device-format MIC2 --------------------------------------------------
    for name in ("ind", "tmp"):
        fx = (TESTDATA / f"series_dev_{name}.mic2").read_bytes()
        raw = np.fromfile(TESTDATA / f"series_dev_{name}.raw", "<u2").reshape(3, -1)
        t0 = time.perf_counter()
        ok = True
        for i in range(16):
            if i == 0:
                (frames, hdr), _c = _counted(
                    f"decompress_multi_frame_device series_dev_{name}",
                    lambda: decompress_multi_frame_device(fx, dev),
                    (rd.rans_decode_direct_groups,))
            else:
                frames, hdr = decompress_multi_frame_device(fx, dev)
            ok = ok and len(frames) == 3 and all(np.array_equal(f, r) for f, r in zip(frames, raw))
        dec_s = time.perf_counter() - t0
        check(f"decompress_multi_frame_device series_dev_{name} x16 ({dec_s:.3f} s, "
              f"{16 * raw.nbytes / dec_s / 1e6:.3f} MB/s of pixels, staging included)", ok)
        t0 = time.perf_counter()
        made, _c = _counted(
            f"compress_multi_frame_device series_dev_{name}",
            lambda: compress_multi_frame_device(list(raw), hdr.width, hdr.height,
                                                int(raw[0].max()), dev, temporal=hdr.temporal),
            (renc.rans_encode,))
        check(f"compress_multi_frame_device series_dev_{name} vs fixture "
              f"({time.perf_counter() - t0:.3f} s)", made == fx)
    return total


def _wavelet_phase(dev, slide):
    """Phase 9: the multi-level 2-D wavelet at 5 levels; returns the row
    wrappers' launch counts."""
    import numpy as np
    import torch

    from mic_tpu_torch import wavelet_forward_2d_separated, wavelet_inverse_2d_separated
    from mic_tpu_torch.tpu import kernels as K

    green = np.ascontiguousarray(slide[:, :, 1]).astype(np.int32)
    images = {"CT_dev 512x512": np.fromfile(TESTDATA / "CT_dev.raw", "<u2").astype(np.int32)
              .reshape(512, 512),
              f"slide green {green.shape[1]}x{green.shape[0]}": green,
              "slide green crop 1001x749": np.ascontiguousarray(green[300:1049, 500:1501])}
    total = {"wt53_rows_forward": 0, "wt53_rows_inverse": 0}
    for name, img in images.items():
        rows, cols = img.shape
        x = torch.from_numpy(img).to(dev)
        kw = dict(rows=rows, cols=cols, levels=5)
        coeffs, c_f = _counted(f"wavelet_forward_2d_separated {name}",
                               lambda: wavelet_forward_2d_separated(x, **kw),
                               (K.wt53_rows_forward,))
        back, c_i = _counted(f"wavelet_inverse_2d_separated {name}",
                             lambda: wavelet_inverse_2d_separated(coeffs, **kw),
                             (K.wt53_rows_inverse,))
        torch.cuda.synchronize()
        total["wt53_rows_forward"] += c_f["wt53_rows_forward"]
        total["wt53_rows_inverse"] += c_i["wt53_rows_inverse"]
        t0 = time.perf_counter()
        want = wavelet_forward_2d_separated(torch.from_numpy(img), **kw)  # CPU: the plain twins
        cpu_s = time.perf_counter() - t0
        fwd_ok, inv_ok = torch.equal(coeffs.cpu(), want), torch.equal(back, x)
        fwd_ms = _cuda_ms(lambda: wavelet_forward_2d_separated(x, **kw), 5)
        inv_ms = _cuda_ms(lambda: wavelet_inverse_2d_separated(coeffs, **kw), 5)
        print(f"wavelet {name} levels=5: forward_equals_cpu={fwd_ok} inverse_gives_input={inv_ok} "
              f"forward_ms={fwd_ms:.3f} inverse_ms={inv_ms:.3f} (CUDA events, 2 row launches "
              f"a level plus torch transposes and de-interleaves) cpu_forward_s={cpu_s:.3f}")
        if not (fwd_ok and inv_ok):
            raise AssertionError(f"wavelet {name}: forward_equals_cpu={fwd_ok} "
                                 f"inverse_gives_input={inv_ok}")
    return total


def _entropy_bytes(blobs) -> int:
    """Decoded u16 bytes of the entropy strips of ``blobs``."""
    from mic_tpu_torch.tpu.strips import STRIP_MODE_CONST, STRIP_MODE_RAW, micw_parse

    total = 0
    for blob in blobs:
        bw, bh, _ns, strip_h, _mv, _gp, _lanes, strips = micw_parse(blob)
        total += 2 * sum(min(strip_h, bh - i * strip_h) * bw for i, st in enumerate(strips)
                         if st[5] not in (STRIP_MODE_RAW, STRIP_MODE_CONST))
    return total


def _scan_batch():
    """Phase 10's containers (SCAN_ENCODE encoded here by the port's host
    encoder, and the FF 41 fixtures above tableLog 12), expected pixels and
    names, in batch order."""
    import numpy as np

    from mic_tpu_torch import micw_compress

    blobs, expected, names = [], [], []
    t0 = time.perf_counter()
    for name, raw, w, h, lanes, pred, ent, reps in SCAN_ENCODE:
        px = np.fromfile(TESTDATA / raw, dtype="<u2")
        blob = micw_compress(px, w, h, int(px.max()), lanes=lanes, predictor=pred, entropy=ent)
        blobs += [blob] * reps
        expected += [px] * reps
        names += [name] * reps
    enc_s = time.perf_counter() - t0
    ct = np.fromfile(TESTDATA / "CT_dev.raw", dtype="<u2")
    for tl, fname in SCAN_FIXTURES.items():
        blobs += [(PORT_DATA / fname).read_bytes()] * SCAN_FIXTURE_REPS
        expected += [ct] * SCAN_FIXTURE_REPS
        names += [f"CT_dev_alias_tl{tl}"] * SCAN_FIXTURE_REPS
    print(f"scan tier: {len(SCAN_ENCODE)} containers encoded by the host encoder in "
          f"{enc_s:.3f} s, {len(SCAN_FIXTURES)} FF 41 fixtures above tableLog 12")
    return blobs, expected, names


def _lanes_shape(packing) -> str:
    """A lanes-kernel packing's launches: for each form its blocks, teams
    (strips) a block or threads, shared memory a block, blocks an SM and
    registers a thread."""
    from mic_tpu_torch.tpu.scan_decode import TEAMS, _launch_shape

    parts = []
    if len(packing.teams):
        smem, occ, regs = _launch_shape(packing)
        parts.append(f"warp form: {len(packing.teams)} blocks of up to {TEAMS} strips (a warp "
                     f"each), {smem} bytes of shared memory a block, {occ} blocks an SM, "
                     f"{regs} registers a thread")
    if len(packing.blocks):
        smem, occ, regs = _launch_shape(packing, wide=True)
        parts.append(f"block form: {len(packing.blocks)} blocks of {packing.threads} threads "
                     f"({packing.lpt} lanes a thread at most), {smem} bytes of shared memory a "
                     f"block, {occ} blocks an SM, {regs} registers a thread")
    buckets = int(packing.desc["alias"].sum())
    return "; ".join(parts) + (f"; the FF 41 strips of {buckets} group(s) read bucket tables "
                               f"from shared memory, every other table from device memory")


def _symbols_out(groups):
    """Lanes-kernel groups with their inverse dropped (symbols out)."""
    return [(fn, ops, {"steps": kw["steps"]}) for fn, ops, kw in groups]


def _lanes_account(r, groups, outputs, ms, plain_ms) -> None:
    """Adds timed lanes-kernel groups to their report entry: the step's
    operations per decoded symbol, and for a fused group the inverse's per
    pixel (pdd's column carry on top)."""
    _account(r, "rans_decode_lanes", [t for _f, ops, _k in groups for t in ops], outputs, ms,
             plain_ms)
    for (_fn, ops, kw), out in zip(groups, outputs):
        inv = kw.get("inverse")
        if inv:
            r["ops"] += (OPS_PER_ELEMENT["lanes_inverse"]
                         + (OPS_PER_ELEMENT["lanes_column"] if inv == "pdd" else 0)) * out.numel()


def _lanes_kernels_vs_plain(dev, report, blobs) -> None:
    """Phase 2, scan half: the plain twin once on every scan bucket of
    phase 10's batch (timed; the fused form's inverse applied to its
    symbols), the lanes kernel on each bucket in both forms against it (the
    warp form through the one-bucket wrapper, with the bucket's inverse;
    the block form symbols out), then the plan's launch in both forms
    against them all; then CT_dev's first 128 rows at SCAN_EXTRA_LANES
    lanes.  Prints ns a step and each launch's shape, and its wall
    seconds."""
    import numpy as np
    import torch

    from mic_tpu_torch import MicwDecodePlan, micw_compress
    from mic_tpu_torch.tpu import scan_decode as sd

    t_half = time.perf_counter()
    r = report["rans_decode_lanes"]

    def plain(b):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        sym = sd.rans_decode_lanes_plain(*b.ops, steps=b.kwargs["steps"])
        inv = b.kwargs.get("inverse")
        want = sym if inv is None else sd._inverse_plain(sym, inv, b.kwargs["width"],
                                                         b.kwargs["strip_h"])
        end.record()
        torch.cuda.synchronize()
        return sym, want, start.elapsed_time(end)

    def compare(tag, key, b, timed):
        sym, want, plain_ms = plain(b)
        steps = min(b.kwargs["steps"], want.shape[1] // b.ops[0].shape[1])
        line = []
        for form, warp_lanes, kw, expect in (("warp", sd.WARP_LANES, b.kwargs, want),
                                             ("block", 0, {"steps": b.kwargs["steps"]}, sym)):
            if warp_lanes and b.ops[0].shape[1] > warp_lanes:
                continue
            if form == "warp":
                got = b.fn(*b.ops, **kw)  # the wrapper, as the plan's bucket calls it
            pk = sd.LanesPacking([(b.fn, b.ops, kw)], warp_lanes=warp_lanes)
            if form == "block":
                (got,) = sd._lanes_launch(pk)
            torch.cuda.synchronize()
            err = int((got.to(torch.int32) - expect.to(torch.int32)).abs().max())
            if not torch.equal(got, expect):
                raise AssertionError(f"rans_decode_lanes {tag} {key} {form} form: kernel != "
                                     f"plain (max abs err {err})")
            r["max_abs_err"] = max(r["max_abs_err"], err)
            ms = _cuda_ms(lambda: sd._lanes_launch(pk), 10)
            if timed and form == "warp":
                _lanes_account(r, [(b.fn, b.ops, kw)], (got,), ms, plain_ms)
            line.append(f"{form} form{' ' + kw['inverse'] + ' fused' if 'inverse' in kw else ''}"
                        f" {ms:.3f} ms ({ms * 1e6 / steps:.1f} ns a step; {_lanes_shape(pk)})")
        tls = sorted({int(t) for t in b.ops[6].cpu()})
        print(f"kernel-vs-plain rans_decode_lanes {tag} bucket={key} strips={b.n} "
              f"lanes={b.ops[0].shape[1]} steps={steps} tls={tls} equal=True "
              f"plain_ms={plain_ms:.3f}: " + " | ".join(line))
        return sym, want, plain_ms

    plan = MicwDecodePlan(blobs, dev)
    compared = [compare("phase-10-batch", k, plan.buckets[k], True) for k in plan._scan_keys]
    plain_ms = sum(ms for _s, _w, ms in compared)
    groups = plan._scan_groups
    for form, pk, want in (("warp", plan.scan_packing, [w for _s, w, _m in compared]),
                           ("block", sd.LanesPacking(_symbols_out(groups), warp_lanes=0),
                            [sym for sym, _w, _m in compared])):
        got = sd._lanes_launch(pk)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"lanes launch, {form} form: kernel != plain "
                                 f"(max abs err {err})")
        ms = _cuda_ms(lambda: sd._lanes_launch(pk), 10)
        what = "the plan's inverses fused" if form == "warp" else "symbols out"
        print(f"kernel-vs-plain lanes launch phase-10-batch {form} form: {len(groups)} groups "
              f"({sum(ops[0].shape[0] for _f, ops, _k in groups)} strips, {what}) equal=True "
              f"kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} (the buckets' plain twins); "
              f"{pk.n_launches} launch(es); {_lanes_shape(pk)}")
    del plan, compared, got
    ct = np.fromfile(TESTDATA / "CT_dev.raw", dtype="<u2")[: 128 * 512]
    for lanes in SCAN_EXTRA_LANES:
        blob = micw_compress(ct, 512, 128, int(ct.max()), num_strips=1, lanes=lanes)
        plan = MicwDecodePlan([blob], dev)
        for key in plan._scan_keys:
            compare(f"CT_dev_rows128_l{lanes}", key, plan.buckets[key], False)
        mism = plan.verify_batch(plan.run(), [ct])
        if mism:
            raise AssertionError(f"CT_dev's first 128 rows at {lanes} lanes: {mism} mismatches")
        del plan
    print(f"phase 2, lanes half: {time.perf_counter() - t_half:.3f} s wall")


def _scan_phase(dev, blobs, expected, names, report):
    """Phase 10: the scan-tier decode; returns the run's launch counts
    (the compare kernel's of its timed runner among them)."""
    import numpy as np
    import torch

    from mic_tpu_torch import (
        MicwDecodePlan,
        compress_multi_frame_device,
        decompress_multi_frame_device,
        micw_parse,
    )
    from mic_tpu_torch.dryrun import tiny_micw_batch
    from mic_tpu_torch.tpu import scan_decode as sd
    from mic_tpu_torch.tpu.decode import mict_decode_device
    from mic_tpu_torch.tpu.device_rans import mict_decode_numpy
    from mic_tpu_torch.tpu.post import post_batch

    t_phase = time.perf_counter()
    grp = sd.rans_decode_lanes_groups
    timed_bytes = _entropy_bytes(blobs)
    t0 = time.perf_counter()
    plan = MicwDecodePlan(blobs, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    fused = [k for k in plan._scan_keys if plan.buckets[k].post is None]
    grp.launches = 0
    post_batch.calls = 0
    t0 = time.perf_counter()
    decoded = plan.run()
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    launches = {"rans_decode_lanes": grp.launches}
    post_calls = post_batch.calls
    kinds = {}
    for key, b in plan.buckets.items():
        kind = f"{key[0]}:{key[1]}:{key[3]}" if key[0] == "scan" else key[0]
        kinds[kind] = kinds.get(kind, 0) + b.n
    n_strips = sum(b.n for b in plan.buckets.values())
    mism = plan.verify_batch(decoded, expected)
    outs = plan.assemble(decoded)
    bad = [i for i, ((px, _w, _h), exp) in enumerate(zip(outs, expected))
           if px.dtype != np.uint16 or not np.array_equal(px, exp)]
    print(f"scan tier: {len(blobs)} images, {n_strips} entropy strips in {len(plan.buckets)} "
          f"buckets {kinds}, stage_s={stage_s:.3f} first_run_s={first_run_s:.3f} "
          f"mismatches={mism} bad_images={len(bad)} launches={launches}")
    print(f"scan tier: {len(fused)} fused buckets (the inverse in the kernel), "
          f"{len(plan._scan_keys) - len(fused)} unfused; {post_calls} post_batch calls in one "
          f"plan.run() (design: {len(plan._scan_keys) - len(fused)})")
    if mism or bad:
        raise AssertionError(f"scan tier decoded wrong pixels: {mism} mismatches, "
                             f"images {[names[i] for i in bad[:10]]}")
    if (grp.launches != LANES_LAUNCHES_PER_RUN or len(plan._scan_keys) != len(plan.buckets)):
        raise AssertionError(f"the scan tier made {grp.launches} lanes-kernel launches in one "
                             f"plan.run() for {len(plan._scan_keys)} of {len(plan.buckets)} "
                             f"buckets, the design makes {LANES_LAUNCHES_PER_RUN} for all")
    if len(fused) != len(plan._scan_keys) or post_calls:
        raise AssertionError(f"phase 10's direct buckets must all run fused: {len(fused)} of "
                             f"{len(plan._scan_keys)} fused, {post_calls} post_batch calls")
    print(f"scan tier: {grp.launches} lanes-kernel launch per plan.run() for "
          f"{len(plan._scan_keys)} scan buckets (design: {LANES_LAUNCHES_PER_RUN}); "
          f"{_lanes_shape(plan.scan_packing)}")
    # plan.run() and the launch alone, interleaved in one loop, each
    # between its own pair of CUDA events; the first and the last timed
    # runs verified strip by strip.
    plan.run()
    sd._lanes_launch(plan.scan_packing)
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(SCAN_REPS)]
    timed = []
    for i, (e0, e1, e2) in enumerate(ev):
        e0.record()
        out = plan.run()
        e1.record()
        sd._lanes_launch(plan.scan_packing)
        e2.record()
        if i in (0, SCAN_REPS - 1):
            timed.append(out)
    torch.cuda.synchronize()
    run_ms = sorted(e0.elapsed_time(e1) for e0, e1, _e2 in ev)
    launch_ms = sorted(e1.elapsed_time(e2) for _e0, e1, e2 in ev)
    timed_mism = [plan.verify_batch(out, expected) for out in timed]
    args = plan.scan_packing.desc["arg"]
    chain = int(np.minimum(args[:, 3], args[:, 6]).max())  # steps, output steps
    med = SCAN_REPS // 2
    gbs = [timed_bytes / (ms / 1e3) / 1e9 for ms in (run_ms[-1], run_ms[med], run_ms[0])]
    print(f"scan tier, {SCAN_REPS} interleaved pairs by CUDA events: plan.run() "
          f"{run_ms[0]:.3f} / {run_ms[med]:.3f} / {run_ms[-1]:.3f} ms (least / median / most), "
          f"{gbs[0]:.3f} / {gbs[1]:.3f} / {gbs[2]:.3f} GB/s of decoded u16 pixels "
          f"({timed_bytes} bytes); the lanes launch alone {launch_ms[0]:.3f} / "
          f"{launch_ms[med]:.3f} / {launch_ms[-1]:.3f} ms ({launch_ms[med] * 1e6 / chain:.1f} "
          f"ns a step of the longest chain, {chain}, at the median); the first and the last "
          f"timed runs: mismatches={timed_mism}, {grp.launches} launches and "
          f"{post_batch.calls} post_batch calls in {SCAN_REPS + 2} runs")
    if (any(timed_mism) or grp.launches != (SCAN_REPS + 2) * LANES_LAUNCHES_PER_RUN
            or post_batch.calls):
        raise AssertionError(f"timed scan runs: {timed_mism} mismatches, {grp.launches} "
                             f"launches, {post_batch.calls} post_batch calls")
    del timed, out
    launches["count_mismatches"] = _timed_runner("scan tier", plan, expected, timed_bytes,
                                                 report)
    _out, wall_ms, by_name, span = _profiled(plan.run)
    busy = sum(by_name.values())
    lanes_ms = sum(v for k, v in by_name.items() if "lanes_" in k)
    print(f"profile: one plan.run(): wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
          f"device_span_ms={span:.3f} idle_share_of_span={1 - busy / span:.3f} "
          f"lanes_kernel_ms={lanes_ms:.3f} device_kernel_names={len(by_name)}")
    del plan, decoded, outs

    # The graft entry's step on its tiny 64-lane batch.
    ops, kw, img = tiny_micw_batch(num_strips=4)
    px = img.ravel()
    got, _c = _counted("decode_strip_batch (tiny 64-lane batch)",
                       lambda: sd.decode_strip_batch(*ops, **kw, device=dev),
                       (sd.rans_decode_lanes,))
    ok = np.array_equal(got.cpu().numpy().view(np.uint16).reshape(-1)[: px.size], px)
    print(f"scan tier: decode_strip_batch on the graft entry's 4 x 64-lane batch "
          f"{tuple(got.shape)}: equal={ok}")
    # One 64-lane MICT stream.
    stream = micw_parse(blobs[0])[7][0][0]
    syms, _c = _counted("mict_decode_device (one 64-lane stream)",
                        lambda: mict_decode_device(stream, dev), (sd.rans_decode_lanes,))
    ok_stream = np.array_equal(syms, mict_decode_numpy(stream))
    print(f"scan tier: mict_decode_device on a {syms.size}-symbol 64-lane stream: "
          f"equal={ok_stream}")
    # A 64-lane series: the host encoder's copy, then the scan tier.
    raw = np.fromfile(TESTDATA / "series_dev_ind.raw", "<u2").reshape(3, -1)
    t0 = time.perf_counter()
    series = compress_multi_frame_device(list(raw), 512, 512, int(raw.max()), dev, lanes=64)
    enc_s = time.perf_counter() - t0
    (frames, _hdr), _c = _counted("decompress_multi_frame_device (64-lane series)",
                                  lambda: decompress_multi_frame_device(series, dev),
                                  (grp,))
    ok_series = len(frames) == 3 and all(np.array_equal(f, r) for f, r in zip(frames, raw))
    print(f"scan tier: compress_multi_frame_device(lanes=64) on series_dev_ind.raw "
          f"({len(series)} bytes, {enc_s:.3f} s on the host), decoded: equal={ok_series}")
    if not (ok and ok_stream and ok_series):
        raise AssertionError(f"scan tier entry points: decode_strip_batch {ok}, "
                             f"mict_decode_device {ok_stream}, 64-lane series {ok_series}")
    print(f"phase 10: {time.perf_counter() - t_phase:.3f} s wall")
    return launches


def _cuda_shards(mesh) -> int:
    """The launches a sharded call over ``mesh`` makes: one a CUDA shard."""
    return sum(d.type == "cuda" for d in mesh)


def _sharded_timing(mesh, call):
    """``call()`` (a sharded call over ``mesh``) run twice: its outputs and,
    a run each, the host seconds to return, the wall seconds to every
    device's end and the ms by CUDA events on the first device's stream."""
    import torch

    runs = []
    for _ in range(2):
        for d in set(mesh):
            torch.cuda.synchronize(d)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        with torch.cuda.device(mesh[0]):
            start.record()
        out = call()
        host_s = time.perf_counter() - t0
        with torch.cuda.device(mesh[0]):
            end.record()
        for d in set(mesh):
            torch.cuda.synchronize(d)
        runs.append((host_s, time.perf_counter() - t0, start.elapsed_time(end)))
    return out, runs


def _runs(runs) -> str:
    return "; ".join(f"host {h:.4f} s to return, wall {w:.4f} s, {ms:.3f} ms by CUDA events"
                     for h, w, ms in runs)


def _mesh_ct_decode(label, mesh, plan, raw) -> None:
    """Phase 11, full width: CT_dev x256's buckets (the main path's 1024
    strips of 512 steps: zzd, vdd, pdd) through
    ``decode_strips_sharded_pallas``; each bucket equal to the unsharded
    wrapper call, every strip verified against ``CT_dev.raw`` (pdd's column
    sum after the gather, as ``mic_tpu``'s plan takes it), one direct launch
    a shard; then the shards' launches alone beside the unsharded ones."""
    import torch

    from mic_tpu_torch.tpu import mesh as M
    from mic_tpu_torch.tpu import rans_decode as rd

    n = len(mesh)
    buckets = list(plan.buckets.items())
    grp = rd.rans_decode_direct_groups
    before = grp.launches

    def call():
        return {k: M.decode_strips_sharded_pallas(mesh, *b.ops, n_strips=b.n // n, **b.kwargs)
                for k, b in buckets}

    shards, runs = _sharded_timing(mesh, call)
    launched = grp.launches - before
    decoded = {}
    for k, b in buckets:
        out = M.gather(shards[k], plan.device)
        if not torch.equal(out, rd.rans_decode_zzd(*b.ops, **b.kwargs)):
            raise AssertionError(f"mesh {label}: bucket {k} != the unsharded call")
        decoded[k] = (rd._pdd_columns_plain(out, b.geom[0] // 128) if b.geom else out
                      ).reshape(b.n, -1)
    mism = plan.verify_batch(decoded, [raw] * len(plan.blobs))
    # the shards' launches alone: each shard's packing, built here as the
    # wrapper builds it
    packings = []
    for _k, b in buckets:
        per = b.n // n
        for i, d in enumerate(mesh):
            with torch.cuda.device(d):
                ops = tuple(t[i * per:(i + 1) * per].to(d) for t in b.ops)
                packings.append(rd.DirectPacking([(rd.rans_decode_zzd, ops, b.kwargs)]))
    with torch.cuda.device(mesh[0]):
        alone_ms = _cuda_ms(lambda: [rd._direct_launch(pk) for pk in packings], 10)
    print(f"mesh {label}: decode_strips_sharded_pallas, CT_dev x{len(plan.blobs)}'s "
          f"{len(buckets)} buckets "
          f"({sum(b.n for _k, b in buckets)} strips of {buckets[0][1].kwargs['steps']} steps), "
          f"{n} shards each: {launched} direct launches in 2 runs, equal to the unsharded "
          f"calls, mismatches={mism} against CT_dev.raw; the sharded calls: {_runs(runs)}; "
          f"the {len(packings)} shard launches alone {alone_ms:.3f} ms (CUDA events)")
    if mism or launched != 2 * _cuda_shards(mesh) * len(buckets):
        raise AssertionError(f"mesh {label}: {mism} mismatches, {launched} launches")


def _scan_strip_batches(blob, px, reps):
    """Phase 11: a container's strips, replicated ``reps`` times, as
    ``decode_strip_batch`` operands, one batch a predictor: (predictor,
    operands, statics, expected u16 [S, width * strip_h]) each."""
    import numpy as np

    from mic_tpu_torch import micw_parse
    from mic_tpu_torch.ops.predictors import delta_params
    from mic_tpu_torch.tpu import scan_decode as sd
    from mic_tpu_torch.tpu.device_rans import mict_parse
    from mic_tpu_torch.tpu.strips import strip_predictor

    width, _h, _ns, strip_h, mv, gpred, _l, strips = micw_parse(blob)
    delim = int(delta_params(mv)[1])
    by_pred = {}
    for i, st in enumerate(strips):
        by_pred.setdefault(strip_predictor(gpred, st[5]), []).append(i)
    out = []
    for pred, idx in by_pred.items():
        parsed = [mict_parse(strips[i][0]) for i in idx] * reps
        tl = parsed[0][1]
        arrays, meta = sd.build_strip_batch(parsed, [strips[i] for i in idx] * reps, tl)
        static = dict(table_log=tl, n_steps=meta["n_steps"], width=width, strip_h=strip_h,
                      max_runs=meta["max_runs"], max_tokens=meta["max_tokens"],
                      mid_count=(1 << (delim.bit_length() - 1)) - 1, delim=delim,
                      predictor=pred)
        rows = np.stack([px[i * strip_h * width:(i + 1) * strip_h * width] for i in idx] * reps)
        out.append((pred, arrays, static, rows))
    return out


def _mesh_scan_decode(label, mesh, batches, unsharded) -> None:
    """Phase 11, the scan tier at full width: phase 10's 64-lane CT_dev x256
    through ``decode_strips_sharded``, one batch a predictor; each equal
    to the unsharded ``decode_strip_batch``, every strip verified, one
    lanes launch a shard; then the shards' launches alone."""
    import numpy as np
    import torch

    from mic_tpu_torch.tpu import mesh as M
    from mic_tpu_torch.tpu import scan_decode as sd

    n = len(mesh)
    grp = sd.rans_decode_lanes_groups
    before = grp.launches
    shards, runs = _sharded_timing(mesh, lambda: [M.decode_strips_sharded(mesh, *a, **st)
                                                  for _p, a, st, _r in batches])
    launched = grp.launches - before
    mism = 0
    packings = []
    for (pred, arrays, static, rows), got, want in zip(batches, shards, unsharded):
        out = M.gather(got, mesh[0])
        if not torch.equal(out, want):
            raise AssertionError(f"mesh {label}: the {pred} batch != the unsharded call")
        mism += int(np.count_nonzero(out.cpu().numpy().view(np.uint16) != rows))
        per = len(rows) // n
        for i, d in enumerate(mesh):
            host, kw, _post = sd.strip_batch_host(*(a[i * per:(i + 1) * per] for a in arrays),
                                                  **static)
            with torch.cuda.device(d):
                packings.append(sd.LanesPacking([(sd.rans_decode_lanes,
                                                  sd.lane_tensors(host, d), kw)]))
    with torch.cuda.device(mesh[0]):
        alone_ms = _cuda_ms(lambda: [sd._lanes_launch(pk) for pk in packings], 10)
    print(f"mesh {label}: decode_strips_sharded, 64-lane CT_dev x{MESH_REPS} "
          f"({sum(len(b[3]) for b in batches)} strips in {len(batches)} batches: "
          f"{[b[0] for b in batches]}), {n} shards each: {launched} lanes launches in 2 runs, "
          f"equal to the unsharded calls, mismatches={mism} against CT_dev.raw; the sharded "
          f"calls: {_runs(runs)}; the {len(packings)} shard launches alone {alone_ms:.3f} ms")
    if mism or launched != 2 * _cuda_shards(mesh) * len(batches):
        raise AssertionError(f"mesh {label}: {mism} mismatches, {launched} launches")


def _mesh_phase(dev, scan_blobs, scan_expected) -> None:
    """Phase 11: the multi-device tier (``tpu/mesh.py``) on the card."""
    import numpy as np
    import torch

    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch.dryrun import dryrun_multichip
    from mic_tpu_torch.tpu import mesh as M
    from mic_tpu_torch.tpu import rans_decode as rd
    from mic_tpu_torch.tpu import rans_encode as renc
    from mic_tpu_torch.tpu import scan_decode as sd

    t_phase = time.perf_counter()
    for n in MESH_DRYRUN:
        dryrun_multichip(n)
    count = torch.cuda.device_count()
    meshes = [(f"[cuda:0] x {k}", M.make_strip_mesh([dev] * k)) for k in MESH_SHARDS]
    if count > 1:  # the cards themselves, a power of two of them (the batches divide)
        cards = 1 << (count.bit_length() - 1)
        meshes.append((f"{cards} of {count} cards",
                       M.make_strip_mesh([torch.device("cuda", i) for i in range(cards)])))
    print(f"mesh: {count} visible CUDA device(s); meshes {[label for label, _m in meshes]}")

    plan = MicwDecodePlan([(TESTDATA / "CT_dev.micw").read_bytes()] * MESH_REPS, dev)
    raw = np.fromfile(TESTDATA / "CT_dev.raw", dtype="<u2")
    with_plan = _cuda_ms(lambda: rd._direct_launch(plan.direct_packing), 10)
    print(f"mesh: unsharded, CT_dev x{MESH_REPS}'s plan in one direct launch {with_plan:.3f} ms "
          f"(CUDA events)")
    for label, mesh in meshes:
        _mesh_ct_decode(label, mesh, plan, raw)
    del plan

    batches = _scan_strip_batches(scan_blobs[0], scan_expected[0], MESH_REPS)
    unsharded = [sd.decode_strip_batch(*a, **st, device=dev) for _p, a, st, _r in batches]
    whole = []
    for _p, arrays, static, _r in batches:
        host, kw, _post = sd.strip_batch_host(*arrays, **static)
        whole.append((sd.rans_decode_lanes, sd.lane_tensors(host, dev), kw))
    packing = sd.LanesPacking(whole)
    one_ms = _cuda_ms(lambda: sd._lanes_launch(packing), 10)
    print(f"mesh: unsharded, the 64-lane CT_dev x{MESH_REPS} batches in one lanes launch "
          f"{one_ms:.3f} "
          f"ms (CUDA events)")
    del whole, packing
    for label, mesh in meshes[:len(MESH_SHARDS)]:
        _mesh_scan_decode(label, mesh, batches, unsharded)
    del batches, unsharded

    for alias, sharded, kernel in ((False, M.encode_strips_sharded, renc.rans_encode),
                                   (True, M.encode_alias_sharded, renc.rans_encode_alias)):
        staged, ops, widths = _encode_operands(dev, alias, 128)
        want = kernel(*ops, steps=staged.steps, widths=widths)
        for k, operands, w in ((2, ops, widths), (4, staged.ops, staged.widths)):
            before = kernel.launches
            t0 = time.perf_counter()
            got = M.gather(sharded(M.make_strip_mesh([dev] * k), *operands, steps=staged.steps,
                                   widths=w), dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = kernel.launches - before
            equal = all(torch.equal(g, x) for g, x in zip(got, want))
            print(f"mesh [cuda:0] x {k}: {sharded.__name__}, phase 2's {len(staged.widths)} "
                  f"streams of {staged.steps} steps ({'tensors' if k == 2 else 'numpy'} on "
                  f"the host side), widths sharded: equal to the unsharded call={equal}, "
                  f"{launched} launches, {wall:.3f} s wall")
            if not equal or launched != _cuda_shards([dev] * k):
                raise AssertionError(f"{sharded.__name__} x {k}: equal={equal}, {launched} "
                                     f"launches")
        del staged, ops, widths, want, got
    print(f"phase 11: {time.perf_counter() - t_phase:.3f} s wall")


# Phase 12's reference containers, rewritten from their .raw (web/gen_testdata.py).
REF_FIXTURES = ([f"{img}_{k}.mic" for img in ("MR", "CT") for k in ("2s", "4s", "8s", "rans8")]
                + [f"{img}_pics{n}.pics" for img in ("MR", "CT") for n in (4, 8)]
                + ["MR_pica.pica", "CT_pica.pica", "series_ind.mic2", "series_tmp.mic2",
                   "tissue.micr", "tissue.mic3", "grey.mic3"])


def _raw_u16(stem):
    import numpy as np

    return np.fromfile(TESTDATA / f"{stem}.raw", "<u2")


def _rolled_series(img, n):
    """Frame k of a series: ``img`` rolled by k rows (k odd) or k columns
    (k even), so frames 0-2 are web/gen_testdata.py's series."""
    import numpy as np

    return [np.roll(img, k, axis=(k + 1) % 2).ravel() for k in range(n)]


def _mosaic(copies):
    """CT_2s.raw tiled copies x copies, copy (i, j) flipped vertically
    where i is odd and horizontally where j is odd."""
    import numpy as np

    ct = _raw_u16("CT_2s").reshape(512, 512)
    rows = [np.concatenate([ct[:: (-1) ** i, :: (-1) ** j] for j in range(copies)], axis=1)
            for i in range(copies)]
    return np.ascontiguousarray(np.concatenate(rows, axis=0))


def _slide_crop(side):
    import numpy as np

    return np.ascontiguousarray(_slide()[0][TILE:TILE + side, TILE:TILE + side])


def _fixture_container(name):
    """(container, input bytes) of a web/testdata reference fixture,
    written by the port as web/gen_testdata.py writes it with mic_tpu."""
    import numpy as np

    import mic_tpu_torch as m

    stem, ext = name.rsplit(".", 1)
    if ext in ("mic", "pics", "pica"):
        px = _raw_u16(stem)
        w = h = 256 if stem.startswith("MR") else 512
        mx = int(px.max())
        if ext == "mic":
            fn = {"2s": m.compress_single_frame, "4s": m.compress_single_frame_4state,
                  "8s": m.compress_single_frame_8state,
                  "rans8": m.compress_single_frame_rans8}[stem.split("_")[1]]
            return m.write_mic1(w, h, fn(px, w, h, mx)), px.nbytes
        if ext == "pica":
            return m.compress_parallel_strips_adaptive(px, w, h, mx, 4), px.nbytes
        fn = (m.compress_parallel_strips_4state if stem.endswith("4")
              else m.compress_parallel_strips_8state)
        return fn(px, w, h, mx, int(stem[-1])), px.nbytes
    if ext == "mic2":
        ct = _raw_u16("CT_2s").reshape(512, 512)
        frames = _rolled_series(ct, 3)
        return (m.compress_multi_frame(frames, 512, 512, int(ct.max()), stem.endswith("tmp")),
                3 * ct.nbytes)
    if name == "grey.mic3":
        grey = np.frombuffer(_raw_u16("grey").astype("<u2").tobytes(), np.uint8)
        return m.compress_wsi(grey, 256, 256, 1, 16, m.WSIOptions()), grey.nbytes
    rgb = np.fromfile(TESTDATA / "tissue.raw", np.uint8)
    if ext == "micr":
        return m.write_micr(512, 384, m.compress_rgb(rgb, 512, 384)), rgb.nbytes
    return m.compress_wsi(rgb, 512, 384, 3, 8, m.WSIOptions()), rgb.nbytes


def _writer_job(job):
    """Phase 12, one writer in a worker process: returns (label, container,
    input bytes, host seconds of the writer call).  A job is (kind, its
    arguments), the sizes among them (a worker reads no module setting)."""
    import mic_tpu_torch as m

    kind, arg = job
    t0 = time.perf_counter()
    if kind == "fixture":
        blob, n_in = _fixture_container(arg)
        return f"fixture {arg}", blob, n_in, time.perf_counter() - t0
    if kind == "mic2":
        img, temporal, n_frames = arg
        src = _raw_u16(f"{img}_2s")
        side = 512 if img == "CT" else 256
        frames = _rolled_series(src.reshape(side, side), n_frames)
        t0 = time.perf_counter()
        blob = m.compress_multi_frame(frames, side, side, int(src.max()), temporal)
        return (f"mic2 {img} {n_frames}x{side}x{side} {'tmp' if temporal else 'ind'}",
                blob, sum(f.nbytes for f in frames), time.perf_counter() - t0)
    if kind == "mic3":
        rgb = _slide_crop(arg)
        t0 = time.perf_counter()
        blob = m.compress_wsi(rgb.ravel(), arg, arg, 3, 8, m.WSIOptions())
        return f"mic3 {arg}x{arg} RGB", blob, rgb.nbytes, time.perf_counter() - t0
    arg, copies = arg
    px = _mosaic(copies)
    side = px.shape[0]
    flat, mx = px.ravel(), int(px.max())
    t0 = time.perf_counter()
    if kind == "mic1":
        fn = {"2s": m.compress_single_frame, "4s": m.compress_single_frame_4state,
              "8s": m.compress_single_frame_8state, "rans8": m.compress_single_frame_rans8}[arg]
        blob = m.write_mic1(side, side, fn(flat, side, side, mx))
    else:
        fn = m.compress_parallel_strips_4state if arg == 4 else m.compress_parallel_strips_8state
        blob = fn(flat, side, side, mx, 8)
    return f"{kind} {arg} {side}x{side}", blob, px.nbytes, time.perf_counter() - t0


def _write_all():
    """Every writer job of phase 12 in WRITER_PROCS spawned processes,
    longest first; returns {job: (label, container, input bytes, s)}."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    jobs = ([("mic2", ("CT", t, SERIES_FRAMES)) for t in (False, True)]
            + [("mic3", WSI_CROP)] + [("pics", (n, MOSAIC_COPIES)) for n in (4, 8)]
            + [("mic1", (k, MOSAIC_COPIES)) for k in ("2s", "4s", "8s", "rans8")]
            + [("mic2", ("MR", t, SERIES_FRAMES)) for t in (False, True)]
            + [("fixture", name) for name in REF_FIXTURES])
    with ProcessPoolExecutor(max_workers=WRITER_PROCS,
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        results = list(ex.map(_writer_job, jobs))
    return dict(zip(jobs, results))


def _observed_routes(fn):
    """fn() with tpu.ref_decode's entropy batch call observed: returns
    (result, streams routed to the tANS kernel, streams routed to the
    host) over the call."""
    from mic_tpu_torch.tpu import ref_decode

    seen = {"kernel": 0, "host": 0}
    batch = ref_decode.fse_decompress_device_batch

    def observed(blobs, device, stats=None):
        st = {}
        out = batch(blobs, device, stats=st)
        seen["kernel"] += st["kernel"]
        seen["host"] += len(st["host"])
        return out

    ref_decode.fse_decompress_device_batch = observed
    try:
        return fn(), seen["kernel"], seen["host"]
    finally:
        ref_decode.fse_decompress_device_batch = batch


def _reader_call(what, fn, px_bytes, launched):
    """Phase 12 (c): one device reader call, its tANS launches counted from
    0, timed by CUDA events around the call (host route and post stages
    included).  Fails unless the kernel launched exactly when a stream was
    routed to it; appends its launches to ``launched``."""
    import torch

    from mic_tpu_torch.tpu.tans_decode import tans_decode_groups

    tans_decode_groups.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out, kernel, host = _observed_routes(fn)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    n = tans_decode_groups.launches
    print(f"reader {what}: {ms:.3f} ms (CUDA events), {px_bytes / (ms / 1e3) / 1e9:.4f} GB/s of "
          f"pixels ({px_bytes} bytes); tANS launches={n}, streams kernel={kernel} host={host}")
    if (n > 0) != (kernel > 0):
        raise AssertionError(f"{what}: {n} tANS launches for {kernel} kernel-routed streams")
    launched.append(n)
    return out


def _writers_phase(dev):
    """Phase 12: the reference writers, (a)-(d) as the module docstring
    says; returns ({tans_decode, rans_encode, rans_decode_direct_groups:
    launches in the phase}, {writer job: (label, container, input bytes,
    host s)})."""
    import numpy as np

    from mic_tpu_torch import (
        decompress_frames_device,
        decompress_mic2_device,
        decompress_pics_device_many,
        decompress_wsi_level_device,
        ingest_plan,
        read_wsi_header,
    )
    from mic_tpu_torch.ops.pyramid import downsample2x_rgb
    from mic_tpu_torch.tpu import rans_decode as rd
    from mic_tpu_torch.tpu import rans_encode as renc
    from mic_tpu_torch.utils.io import read_mic1

    t_phase = time.perf_counter()
    written = _write_all()
    print(f"writers: {len(written)} containers in {time.perf_counter() - t_phase:.3f} s wall "
          f"({WRITER_PROCS} processes, spawned)")
    for label, blob, n_in, sec in written.values():
        print(f"writer {label}: {sec:.3f} host s, {n_in / sec / 1e6:.3f} MB/s, "
              f"ratio {n_in / len(blob):.4f} ({n_in} -> {len(blob)} bytes)")
    # (a) the fixtures, byte for byte
    bad = [name for name in REF_FIXTURES
           if written[("fixture", name)][1] != (TESTDATA / name).read_bytes()]
    print(f"writers (a): {len(REF_FIXTURES) - len(bad)} of {len(REF_FIXTURES)} reference "
          "fixtures rewritten byte for byte")
    if bad:
        raise AssertionError(f"the port's writers differ from the fixtures: {bad}")

    # (c) the device readers, every pixel against the input
    launched = {}
    mosaic = _mosaic(MOSAIC_COPIES).ravel()
    side = 512 * MOSAIC_COPIES
    mic1 = [read_mic1(written[("mic1", (k, MOSAIC_COPIES))][1])
            for k in ("2s", "4s", "8s", "rans8")]
    mic1 += [read_mic1(written[("fixture", n)][1]) for n in REF_FIXTURES if n.endswith(".mic")]
    want = [mosaic] * 4 + [_raw_u16(n[:-4]) for n in REF_FIXTURES if n.endswith(".mic")]
    outs = _reader_call(f"decompress_frames_device ({len(mic1)} MIC1: the mosaic's 4 + (a)'s 8)",
                        lambda: decompress_frames_device([m[3] for m in mic1],
                                                         [m[:2] for m in mic1], dev),
                        sum(w.nbytes for w in want), launched.setdefault("frames", []))
    if not all(np.array_equal(o, w) for o, w in zip(outs, want)):
        raise AssertionError("decompress_frames_device decoded wrong pixels")
    pics_names = [n for n in REF_FIXTURES if n.endswith(".pics")]
    pics = [written[("pics", (k, MOSAIC_COPIES))][1] for k in (4, 8)] + [
        written[("fixture", n)][1] for n in pics_names]
    want = [mosaic] * 2 + [_raw_u16(n[:-5]) for n in pics_names]
    outs = _reader_call(f"decompress_pics_device_many ({len(pics)} PICS: the mosaic's 2 + "
                        f"(a)'s {len(pics_names)})",
                        lambda: decompress_pics_device_many(pics, dev),
                        sum(w.nbytes for w in want), launched.setdefault("pics", []))
    if not all(np.array_equal(px, w) for (px, _w, _h), w in zip(outs, want)):
        raise AssertionError("decompress_pics_device_many decoded wrong pixels")
    for img, psize in (("CT", 512), ("MR", 256)):
        frames = _rolled_series(_raw_u16(f"{img}_2s").reshape(psize, psize), SERIES_FRAMES)
        for temporal in (False, True):
            label, blob, n_in, _s = written[("mic2", (img, temporal, SERIES_FRAMES))]
            got, _hdr = _reader_call(f"decompress_mic2_device ({label})",
                                     lambda: decompress_mic2_device(blob, dev), n_in,
                                     launched.setdefault("mic2", []))
            if len(got) != len(frames) or not all(np.array_equal(g, f)
                                                  for g, f in zip(got, frames)):
                raise AssertionError(f"decompress_mic2_device decoded wrong pixels: {label}")
    mic3 = written[("mic3", WSI_CROP)][1]
    level_px = _slide_crop(WSI_CROP).ravel()
    lw = lh = WSI_CROP
    for level, lv in enumerate(read_wsi_header(mic3).levels):
        if level:
            level_px, lw, lh = downsample2x_rgb(level_px, lw, lh)
        if (lv.width, lv.height) != (lw, lh):
            raise AssertionError(f"MIC3 level {level}: {lv.width}x{lv.height}, expected {lw}x{lh}")
        got = _reader_call(f"decompress_wsi_level_device (MIC3 {WSI_CROP}x{WSI_CROP} level "
                           f"{level}, {lw}x{lh}, {lv.tiles_x * lv.tiles_y} tiles)",
                           lambda: decompress_wsi_level_device(mic3, level, dev),
                           level_px.nbytes, launched.setdefault("wsi", []))
        if got != level_px.tobytes():
            raise AssertionError(f"decompress_wsi_level_device level {level}: wrong pixels")
    print("readers (c): every pixel equal; calls that launched the tANS kernel: "
          + " ".join(f"{k}={sum(n > 0 for n in v)}/{len(v)}" for k, v in launched.items()))
    if not all(any(v) for v in launched.values()):
        raise AssertionError(f"a device reader never launched the tANS kernel: {launched}")

    # (d) the MIC1 and PICS blobs of (b) ingested to MICW on the card
    ref_blobs = [m[3] for m in mic1[:4]] + pics[:2]
    dims = [(side, side)] * 4 + [None] * 2
    timings = {}
    t0 = time.perf_counter()
    plan, counts = _counted("ingest_plan (b)",
                            lambda: ingest_plan(ref_blobs, dims, dev, entropy="device",
                                                device_encode=True, timings=timings),
                            (renc.rans_encode,))
    ingest_s = time.perf_counter() - t0
    decoded, direct = _counted("ingest_plan (b)'s MicwDecodePlan.run", plan.run,
                               (rd.rans_decode_direct_groups,))
    mism = plan.verify_batch(decoded, [mosaic] * len(ref_blobs))
    n_bytes = mosaic.nbytes * len(ref_blobs)
    print(f"ingest (d): {len(ref_blobs)} blobs ({n_bytes} pixel bytes) in {ingest_s:.3f} s, "
          f"{n_bytes / ingest_s / 1e6:.3f} MB/s, "
          + " ".join(f"{k}={v:.3f}" for k, v in timings.items())
          + f"; {sum(b.n for b in plan.buckets.values())} strips in {len(plan.buckets)} "
          f"buckets, mismatches={mism}")
    if mism:
        raise AssertionError(f"ingest_plan's containers decode to wrong pixels: {mism}")
    print(f"phase 12: {time.perf_counter() - t_phase:.3f} s wall")
    return {"tans_decode": sum(sum(v) for v in launched.values()), **counts, **direct}, written


def _pipeline_job(job):
    """Phase 13 (c), one host pipeline in a worker process: encode and
    decode ``job`` = (pipeline, mosaic copies or 0 for ``CT_2s.raw``);
    returns (label, payload, input bytes, encode s, decode s, pixels
    equal)."""
    import numpy as np

    from mic_tpu_torch.models import single_frame as sf
    from mic_tpu_torch.models import wavelet_pipeline as wp
    from mic_tpu_torch.ops import gapremoval

    name, copies = job
    px = _mosaic(copies).ravel() if copies else _raw_u16("CT_2s")
    side = 512 * max(copies, 1)
    mx = int(px.max())
    wavelet = {"v2": "wavelet_v2_rle_fse", "v1": "wavelet_fse", "v1.5": "wavelet_rle_fse"}
    frame = {"gap": (gapremoval.compress_single_frame_gap_removal,
                     gapremoval.decompress_single_frame_gap_removal),
             "huffman": (sf.compress_single_frame_huffman, sf.decompress_single_frame_huffman)}
    t0 = time.perf_counter()
    if name in wavelet:  # (pixels, rows, cols, max, levels); decode -> (pixels, rows, cols)
        blob = getattr(wp, wavelet[name] + "_compress")(px, side, side, mx, 5)
    else:
        blob = frame[name][0](px, side, side, mx)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if name in wavelet:
        out = getattr(wp, wavelet[name] + "_decompress")(blob)[0]
    else:
        out = frame[name][1](blob, side, side)
    dec_s = time.perf_counter() - t0
    return (f"{name} {side}x{side}", blob, px.nbytes, enc_s, dec_s,
            bool(np.array_equal(out, px)))


def _run_pipelines():
    """Phase 13 (c): every pipeline job in PIPELINE_PROCS spawned
    processes, longest first; returns {job: _pipeline_job's result}."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    jobs = ([(name, MOSAIC_COPIES) for name in ("v2", "huffman", "gap")]
            + [("v1.5", 0), ("v1", 0)])
    with ProcessPoolExecutor(max_workers=PIPELINE_PROCS,
                             mp_context=multiprocessing.get_context("spawn")) as ex:
        results = list(ex.map(_pipeline_job, jobs))
    return dict(zip(jobs, results))


def _decode_counters():
    """The decode wrappers whose launches phase 13 counts."""
    from mic_tpu_torch.tpu import rans_decode as rd
    from mic_tpu_torch.tpu import scan_decode

    return (rd.rans_decode_direct_groups, rd.rans_decode_rle_groups,
            scan_decode.rans_decode_lanes_groups)


def _zero_decode_counts() -> None:
    for w in _decode_counters():
        w.launches = 0
        if hasattr(w, "family_launches"):
            w.family_launches = dict.fromkeys(w.family_launches, 0)


def _decode_counts() -> dict:
    """{wrapper or front end: launches} since _zero_decode_counts, the
    merged launches beside each front end they held."""
    out = {}
    for w in _decode_counters():
        out[w.__name__] = w.launches
        out.update(getattr(w, "family_launches", {}))
    return out


def _oracle_vs_card(dev) -> None:
    """Phase 13 (a): the host oracles against the card and the pixels."""
    import numpy as np

    from mic_tpu_torch.tpu import kernels as K
    from mic_tpu_torch.tpu.rgb_device import micwr_decode_many, micwr_decompress_host
    from mic_tpu_torch.tpu.strips import micw_decode_many, micw_decompress_host

    paths = sorted(TESTDATA.glob("*.micw")) + sorted(PORT_DATA.glob("*.micw"))
    blobs = [p.read_bytes() for p in paths]
    hosts = []
    for path, blob in zip(paths, blobs):
        t0 = time.perf_counter()
        hosts.append(micw_decompress_host(blob))
        print(f"oracle (a): micw_decompress_host {path.name}: {hosts[-1][1]}x{hosts[-1][2]}, "
              f"{time.perf_counter() - t0:.3f} host s")
    _zero_decode_counts()
    cards = micw_decode_many(blobs, dev)
    counts = _decode_counts()
    bad = []
    for path, (px, w, h), (cpx, cw, ch) in zip(paths, hosts, cards):
        want = _fixture_pixels(path)
        if (cw, ch) != (w, h) or not (np.array_equal(px, want) and np.array_equal(cpx, px)):
            bad.append(path.name)
    print(f"oracle (a): {len(paths)} MICW containers, host == card == .raw for "
          f"{len(paths) - len(bad)}; the card decode's launches {counts}")
    if bad:
        raise AssertionError(f"host oracle, card decode and pixels disagree: {bad}")
    if min(counts[w.__name__] for w in _decode_counters()) <= 0:
        raise AssertionError(f"the card decode of the oracle's containers missed a kernel: {counts}")
    blob = (TESTDATA / "tissue_dev.mwr3").read_bytes()
    t0 = time.perf_counter()
    rgb, w, h = micwr_decompress_host(blob)
    host_s = time.perf_counter() - t0
    _zero_decode_counts()
    K.ycocgr_inverse.launches = 0
    ((card, cw, ch),) = micwr_decode_many([blob], dev)
    counts = dict(_decode_counts(), ycocgr_inverse=K.ycocgr_inverse.launches)
    want = np.fromfile(TESTDATA / "tissue_dev.raw", np.uint8)
    ok = (cw, ch) == (w, h) and np.array_equal(rgb, want) and np.array_equal(card, rgb)
    print(f"oracle (a): micwr_decompress_host tissue_dev.mwr3 {w}x{h}: {host_s:.3f} host s, "
          f"host == card == .raw {ok}; the card decode's launches {counts}")
    if not ok or counts["ycocgr_inverse"] <= 0:
        raise AssertionError(f"MWR3 oracle: equal {ok}, launches {counts}")


def _fixture_pixels(path):
    """The pixels a ``.micw`` fixture holds: its ``.raw``, CT_dev's for the
    CT re-encodes, a channel of ``tissue_dev.raw`` for the tissue planes."""
    import numpy as np

    raw = path.with_suffix(".raw")
    if raw.exists():
        return np.fromfile(raw, "<u2")
    if path.name.startswith("CT_dev"):
        return _raw_u16("CT_dev")
    return _tissue_plane(path.name[len("tissue_")])


def _cli_on_card() -> None:
    """Phase 13 (b): ``python -m mic_tpu_torch.cli`` on CT_2s.raw, one
    process a run, all started together, each on the card (no ``-device
    cpu``); each output checked here, the MICW ones decoded back by the
    CLI's ``-decode`` in this process, on the card."""
    import contextlib
    import io
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mic_tpu_torch import cli
    from mic_tpu_torch.models.wavelet_pipeline import wavelet_v2_rle_fse_decompress
    from mic_tpu_torch.ops.gapremoval import decompress_single_frame_gap_removal
    from mic_tpu_torch.tpu.strips import micw_compress

    src = TESTDATA / "CT_2s.raw"
    px = _raw_u16("CT_2s")
    mx = int(px.max())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        runs = {f"micw {e} {p}": ["-micw", "-entropy", e, "-predictor", p]
                for e, p in CLI_PAIRINGS}
        runs.update({"micw -device": ["-micw", "-device"], "wavelet": ["-wavelet"],
                     "gap": ["-gap"]})

        def run(item):
            label, flags = item
            out = tmp / (label.replace(" ", "_") + ".bin")
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-m", "mic_tpu_torch.cli", "-input", str(src),
                                  "-width", "512", "-height", "512", *flags, "-output", str(out)],
                                 cwd=ROOT, capture_output=True, text=True, timeout=300)
            return label, res, out, time.perf_counter() - t0

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(runs)) as ex:
            done = list(ex.map(run, runs.items()))
        print(f"cli (b): {len(done)} CLI processes in {time.perf_counter() - t0:.3f} s wall")
        for label, res, out, sec in done:
            if res.returncode != 0:
                raise AssertionError(f"cli {label}: exit {res.returncode}\n{res.stderr[-2000:]}")
            blob = out.read_bytes()
            if label.startswith("micw"):
                e, p = ("standard", "zzd") if label == "micw -device" else label.split()[1:]
                want = micw_compress(px, 512, 512, mx, entropy=e, predictor=p)
                back = tmp / "back.raw"
                _zero_decode_counts()
                with contextlib.redirect_stdout(io.StringIO()):  # its "decoded ..." line
                    rc = cli.main(["-decode", str(out), "-output", str(back)])
                counts = {k: v for k, v in _decode_counts().items() if v}
                ok = blob == want and rc == 0 and back.read_bytes() == src.read_bytes()
                extra = f"equals host micw_compress({e}, {p}) and decodes back on the card: {ok}; " \
                        f"-decode's launches {counts}"
                if not ok or not counts:
                    raise AssertionError(f"cli {label}: {extra}")
            else:
                dec = (wavelet_v2_rle_fse_decompress(blob)[0] if label == "wavelet"
                       else decompress_single_frame_gap_removal(blob, 512, 512))
                ok = np.array_equal(dec, px)
                extra = f"decodes back on the host: {ok}"
                if not ok:
                    raise AssertionError(f"cli {label}: {extra}")
            print(f"cli (b) {label}: {len(blob)} bytes, ratio {px.nbytes / len(blob):.4f}, "
                  f"{sec:.3f} s in its process ({res.stdout.strip()}); {extra}")


def _lift_on_card(dev, v2_blob) -> dict:
    """Phase 13 (d): the 5/3 lift on the card against the copied host
    transform at the V2 pipeline's shapes; returns the row launches."""
    import struct

    import numpy as np
    import torch

    from mic_tpu_torch.ops.wavelet import wt53_forward_2d_separated
    from mic_tpu_torch.tpu import kernels as K

    rows, cols, _mx, levels = struct.unpack_from("<IIHB", v2_blob, 0)
    img = _mosaic(MOSAIC_COPIES)
    if img.shape != (rows, cols):
        raise AssertionError(f"V2 header {rows}x{cols}, mosaic {img.shape}")
    host = img.astype(np.int64)
    t0 = time.perf_counter()
    r, c = rows, cols
    for _ in range(levels):
        wt53_forward_2d_separated(host, r, c, cols)
        r, c = (r + 1) // 2, (c + 1) // 2
    host_s = time.perf_counter() - t0
    if host.min() < -(1 << 31) or host.max() >= 1 << 31:
        raise AssertionError("host coefficients leave int32")
    x = torch.from_numpy(img.astype(np.int32)).to(dev)
    kw = dict(rows=rows, cols=cols, levels=levels)
    coeffs, c_f = _counted(f"wavelet_forward_2d_separated mosaic {cols}x{rows} levels={levels}",
                           lambda: K.wavelet_forward_2d_separated(x, **kw),
                           (K.wt53_rows_forward,))
    back, c_i = _counted(f"wavelet_inverse_2d_separated mosaic {cols}x{rows} levels={levels}",
                         lambda: K.wavelet_inverse_2d_separated(coeffs, **kw),
                         (K.wt53_rows_inverse,))
    torch.cuda.synchronize()
    fwd_ok = torch.equal(coeffs.cpu(), torch.from_numpy(host.astype(np.int32)))
    inv_ok = torch.equal(back, x)
    fwd_ms = _cuda_ms(lambda: K.wavelet_forward_2d_separated(x, **kw), 5)
    inv_ms = _cuda_ms(lambda: K.wavelet_inverse_2d_separated(coeffs, **kw), 5)
    print(f"lift (d): mosaic {cols}x{rows}, {levels} levels (V2's header): card forward == "
          f"host wt53_forward_2d_separated {fwd_ok} (int32, whole array), inverse gives the "
          f"pixels {inv_ok}; forward_ms={fwd_ms:.3f} inverse_ms={inv_ms:.3f} (CUDA events), "
          f"host forward {host_s:.3f} s")
    if not (fwd_ok and inv_ok):
        raise AssertionError(f"5/3 lift on the card: forward {fwd_ok}, inverse {inv_ok}")
    return {**c_f, **c_i}


def _comparators() -> None:
    """Phase 13 (e): the comparators' availability, and a round trip of
    CT_2s.raw through each one present."""
    import numpy as np

    from mic_tpu_torch.utils import charls, j2k

    px = _raw_u16("CT_2s").reshape(512, 512)
    print(f"comparators (e): charls.available()={charls.available()} "
          f"j2k.available()={j2k.available()}")
    for name, mod, kw in (("charls", charls, {"bits_per_sample": max(int(px.max()).bit_length(), 2)}),
                          ("j2k", j2k, {})):
        if not mod.available():
            continue
        t0 = time.perf_counter()
        blob = mod.encode(px, **kw)
        ok = np.array_equal(mod.decode(blob), px)
        print(f"comparators (e): {name} CT_2s 512x512 round trip {ok}, ratio "
              f"{px.nbytes / len(blob):.4f}, {time.perf_counter() - t0:.3f} host s")
        if not ok:
            raise AssertionError(f"{name} round trip of CT_2s.raw failed")


def _host_tier_phase(dev) -> dict:
    """Phase 13: (a)-(e) as the module docstring says; returns the 5/3 row
    wrappers' launches in (d)."""
    t_phase = time.perf_counter()
    results = _run_pipelines()
    print(f"pipelines (c): {len(results)} pipeline runs in {time.perf_counter() - t_phase:.3f} s "
          f"wall ({PIPELINE_PROCS} processes, spawned)")
    for label, blob, n_in, enc_s, dec_s, ok in results.values():
        print(f"pipeline (c) {label}: encode {enc_s:.3f} host s ({n_in / enc_s / 1e6:.3f} MB/s), "
              f"decode {dec_s:.3f} host s ({n_in / dec_s / 1e6:.3f} MB/s), ratio "
              f"{n_in / len(blob):.4f} ({n_in} -> {len(blob)} bytes), pixels equal {ok}")
        if not ok:
            raise AssertionError(f"pipeline {label} decoded wrong pixels")
    _oracle_vs_card(dev)
    _cli_on_card()
    lift = _lift_on_card(dev, results[("v2", MOSAIC_COPIES)][1])
    _comparators()
    print(f"phase 13: {time.perf_counter() - t_phase:.3f} s wall")
    return lift


def _host_builds():
    """Phase 1's host half: the C++ host tier and its stage profiler,
    built with the host compiler; returns (library, profiler, seconds)."""
    from mic_tpu_torch import _build

    t0 = time.perf_counter()
    lib = _build.host_build()
    _build.host_library()
    prog = _build.host_program()
    return lib, prog, time.perf_counter() - t0


def _least_s(fn, reps):
    """(the least host seconds of ``reps`` calls of fn, its last result)."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def _twins_encode(drans, syms, alias):
    """mict_encode of ``syms`` at 128 lanes on the C++ tier and on its
    numpy twins (``_norm_and_header_numpy``, ``_lane_encode_numpy``):
    each the blob or the sentinel error's name."""
    def one():
        try:
            return drans.mict_encode(syms, lanes=128, alias=alias)
        except (drans.IncompressibleError, drans.UseRLEError) as e:
            return type(e).__name__

    native = one()
    saved = drans._lane_encode, drans._norm_and_header
    drans._lane_encode, drans._norm_and_header = (drans._lane_encode_numpy,
                                                  drans._norm_and_header_numpy)
    try:
        return native, one()
    finally:
        drans._lane_encode, drans._norm_and_header = saved


def _native_equal(host_build):
    """Phase 14 (a)-(b): the build, and the C++ tier's bytes and pixels
    against its plain twins on the fixtures, the writers and phase 4's
    streams."""
    import numpy as np

    from mic_tpu_torch import _build, native
    from mic_tpu_torch.models import single_frame as sf
    from mic_tpu_torch.parallel import strips as pics
    from mic_tpu_torch.tpu import device_rans as drans
    from mic_tpu_torch.tpu.rans_encode import MicwEncodePlan
    from mic_tpu_torch.utils.io import read_mic1

    lib, prog, build_s = host_build
    cxx = _build.host_compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             check=True).stdout.splitlines()[0]
    # the first call in a process with the library built: the compiler's
    # identity (the name's hash) and the load
    _build.host_library.cache_clear()
    t0 = time.perf_counter()
    _build.host_library()
    load_s = time.perf_counter() - t0
    print(f"native (a): {cxx} ({version}), flags {' '.join(_build.HOST_FLAGS)}; "
          f"{lib.name} and {prog.name} built in {build_s:.3f} s (phase 1, beside nvcc); "
          f"the first call of a process with them built {load_s:.3f} s; "
          f"host CPU: {_cpu_model()}, {os.cpu_count()} threads")
    # (b) MIC1 and PICS fixtures: the C++ decode, the Python decode, the .raw
    n = 0
    for name in REF_FIXTURES:
        stem, ext = name.rsplit(".", 1)
        raw = _raw_u16(stem)
        blob = (TESTDATA / name).read_bytes()
        if ext == "mic":
            w, h, _p, payload = read_mic1(blob)
            got = [sf.decode_frame(payload, w, h, "avg", tier) for tier in ("native", "python")]
        elif ext == "pics":
            got = [native.decompress_strips_native(blob)[0],
                   np.asarray(pics.decompress_parallel_strips(blob)[0])]
        else:
            continue
        if not all(np.array_equal(g, raw) for g in got):
            raise AssertionError(f"native (b): {name} decodes to other pixels than its .raw")
        n += 1
    # the writers: the C++ container / frame against the Python writers
    writers = 0
    for stem, side in (("CT_2s", 512), ("MR_2s", 256)):
        px = _raw_u16(stem)
        mx = int(px.max())
        for n_states, frame in ((2, sf.compress_single_frame), (4, sf.compress_single_frame_4state),
                                (8, sf.compress_single_frame_8state)):
            for num_strips in (4, 8):
                nat = native.compress_strips_native(px, side, side, mx, n_states=n_states,
                                                    num_strips=num_strips)
                if nat != pics._compress_strips_python(px, side, side, mx, num_strips, n_states):
                    raise AssertionError(f"native (b): PICS {stem} {n_states} states, "
                                         f"{num_strips} strips: C++ != Python")
            if native.compress_frame_native(px, side, side, mx, kind=native.PRED_AVG,
                                            n_states=n_states) != frame(px, side, side, mx):
                raise AssertionError(f"native (b): MIC1 {stem} {n_states} states: C++ != Python")
            writers += 3
    # phase 4's streams through _norm_and_header and _lane_encode
    streams = equal = 0
    for cont, raw, pred, ent, _reps in ENCODE.values():
        px = np.fromfile(raw, dtype="<u2")
        w, h = struct.unpack_from("<II", cont.read_bytes(), 4)
        plan = MicwEncodePlan([(px, w, h, int(px.max()))], ent, pred)
        for alias, jobs in plan.jobs.items():
            for syms, _max_bytes in jobs:
                nat, twin = _twins_encode(drans, syms, alias)
                streams += 1
                equal += nat == twin
    print(f"native (b): {n} MIC1 / PICS fixtures decoded by the C++ and Python tiers to their "
          f".raw; {writers} containers and frames written by the C++ tier equal to the Python "
          f"writers'; {equal} of {streams} of phase 4's streams encoded (_norm_and_header, "
          "_lane_encode) equal to the numpy twins")
    if equal != streams:
        raise AssertionError(f"native (b): {streams - equal} of phase 4's streams differ")


def _cpu_model() -> str:
    """lscpu's vendor, model name, family and model number."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    fields = dict(ln.split(":", 1) for ln in out.splitlines() if ":" in ln)
    return ", ".join(f"{k} {fields[k].strip()}" for k in ("Vendor ID", "Model name",
                                                          "CPU family", "Model")
                     if k in fields)


def _native_phase(dev, written, host_build) -> dict:
    """Phase 14: the C++ host tier, (a)-(d) as the module docstring says;
    returns the kernels' launches in (c)'s ingest."""
    import numpy as np

    from mic_tpu_torch import ingest_plan, native
    from mic_tpu_torch.models import single_frame as sf
    from mic_tpu_torch.parallel import strips as pics
    from mic_tpu_torch.tpu import rans_decode as rd
    from mic_tpu_torch.tpu import rans_encode as renc
    from mic_tpu_torch.utils.io import read_mic1

    t_phase = time.perf_counter()
    _native_equal(host_build)
    # (c) the mosaic of phase 12, on the host, one process
    mosaic = _mosaic(MOSAIC_COPIES)
    side, flat, mx = mosaic.shape[0], mosaic.ravel(), int(mosaic.max())
    mb = flat.nbytes / 1e6
    mic1 = {k: read_mic1(written[("mic1", (k, MOSAIC_COPIES))][1])[3]
            for k in ("2s", "4s", "8s", "rans8")}
    for k, payload in mic1.items():
        sec, out = _least_s(lambda: sf.decode_frame(payload, side, side, "avg", "native"),
                            NATIVE_REPS)
        if not np.array_equal(out, flat):
            raise AssertionError(f"native (c): decode_frame of the mosaic's MIC1 {k}: wrong pixels")
        print(f"native (c): decode_frame(tier='native') MIC1 {k} {side}x{side}: {sec:.4f} host s, "
              f"{mb / sec:.1f} MB/s of pixels (least of {NATIVE_REPS})")
    for n_states in (4, 8):
        blob = written[("pics", (n_states, MOSAIC_COPIES))][1]
        for threads in (0, 1):
            sec, out = _least_s(lambda: native.decompress_strips_native(blob, n_threads=threads),
                                NATIVE_REPS)
            if not np.array_equal(out[0], flat):
                raise AssertionError(f"native (c): PICS {n_states} states: wrong pixels")
            print(f"native (c): decompress_strips_native PICS {n_states} states, 8 strips, "
                  f"{'a thread a strip (pool)' if threads == 0 else 'one thread'}: "
                  f"{sec:.4f} host s, {mb / sec:.1f} MB/s of pixels")
        writer = (pics.compress_parallel_strips_4state if n_states == 4
                  else pics.compress_parallel_strips_8state)
        sec, out = _least_s(lambda: writer(flat, side, side, mx, 8), NATIVE_REPS)
        if out != blob:
            raise AssertionError(f"native (c): the PICS {n_states}-state writer != phase 12's")
        print(f"native (c): PICS writer {n_states} states, 8 strips: {sec:.4f} host s, "
              f"{mb / sec:.1f} MB/s (phase 12's, in a worker process: "
              f"{written[('pics', (n_states, MOSAIC_COPIES))][3]:.3f} s)")
    for k, n_states in (("2s", 2), ("4s", 4), ("8s", 8)):
        sec, out = _least_s(lambda: native.compress_frame_native(
            flat, side, side, mx, kind=native.PRED_AVG, n_states=n_states), NATIVE_REPS)
        if out != mic1[k]:
            raise AssertionError(f"native (c): compress_frame_native {k} != phase 12's MIC1")
        print(f"native (c): compress_frame_native MIC1 {k}: {sec:.4f} host s, {mb / sec:.1f} "
              f"MB/s (phase 12's Python writer: {written[('mic1', (k, MOSAIC_COPIES))][3]:.3f} s)")
    # ingest_plan on phase 12's blobs, the reference decode on the C++ tier
    ref_blobs = list(mic1.values()) + [written[("pics", (n, MOSAIC_COPIES))][1] for n in (4, 8)]
    dims = [(side, side)] * 4 + [None] * 2
    timings = {}
    t0 = time.perf_counter()
    plan, counts = _counted("ingest_plan(entropy='native') (c)",
                            lambda: ingest_plan(ref_blobs, dims, dev, entropy="native",
                                                device_encode=True, timings=timings),
                            (renc.rans_encode,))
    ingest_s = time.perf_counter() - t0
    decoded, direct = _counted("ingest_plan(entropy='native') (c)'s MicwDecodePlan.run",
                               plan.run, (rd.rans_decode_direct_groups,))
    mism = plan.verify_batch(decoded, [flat] * len(ref_blobs))
    n_bytes = flat.nbytes * len(ref_blobs)
    print(f"native (c): ingest_plan(entropy='native', device_encode=True): {len(ref_blobs)} blobs "
          f"({n_bytes} pixel bytes) in {ingest_s:.3f} s, {n_bytes / ingest_s / 1e6:.3f} MB/s, "
          + " ".join(f"{k}={v:.3f}" for k, v in timings.items()) + f", mismatches={mism}")
    if mism:
        raise AssertionError(f"native (c): ingest_plan's containers decode wrong: {mism}")
    # (d) the native encode's stages on CT_dev.raw
    res = subprocess.run([str(host_build[1]), str(TESTDATA / "CT_dev.raw"), "512", "512", "20"],
                         capture_output=True, text=True, check=True)
    for line in res.stdout.splitlines():
        print(f"native (d): prof_encode CT_dev.raw: {line}")
    print(f"phase 14: {time.perf_counter() - t_phase:.3f} s wall")
    return {**counts, **direct}


def _main_batch():
    """Phase 3's batch: the containers and their expected pixels, batch
    order, and the decoded u16 bytes of its entropy strips."""
    import numpy as np

    names = [k for k, v in BATCH.items() for _ in range(v[2])]
    blobs = {k: v[0].read_bytes() for k, v in BATCH.items()}
    raws = {k: np.fromfile(v[1], dtype="<u2") for k, v in BATCH.items()}
    batch = [blobs[k] for k in names]
    return batch, [raws[k] for k in names], _entropy_bytes(batch)


def _wide_pdd(dev) -> None:
    """Phase 3, a pdd strip too wide for the direct kernel's column carry:
    a ``WIDE_PDD`` image (smooth, with noise from a numpy seed) encoded on
    the card with predictor pdd, then decoded by a plan of its own in one
    direct launch and verified; prints whether its bucket runs fused."""
    import numpy as np
    import torch

    from mic_tpu_torch import MicwDecodePlan, micw_compress_device
    from mic_tpu_torch.tpu import rans_decode as rd

    w, h = WIDE_PDD
    rng = np.random.default_rng(11)
    y, x = np.mgrid[:h, :w]
    px = 2000 + 900 * np.sin(x / 700.0) + 40 * y + rng.integers(0, 24, (h, w))
    px = px.astype(np.uint16).ravel()
    blob = micw_compress_device(px, w, h, int(px.max()), dev, predictor="pdd")
    plan = MicwDecodePlan([blob], dev)
    ((key, b),) = plan.buckets.items()
    before = rd.rans_decode_direct_groups.launches
    run = plan.run()
    torch.cuda.synchronize()
    launched = rd.rans_decode_direct_groups.launches - before
    mism = plan.verify_batch(run, [px])
    form = ("fused" if b.pdd_ws else
            "unfused (pdd_ws 0: the row prefix in the kernel, the column sum in torch ops)")
    print(f"decode path, wide pdd: {w}x{h} encoded on the card ({len(blob)} bytes), bucket "
          f"{key[:2]} runs {form}, {launched} direct launch, "
          f"{plan.direct_packing.smem_bytes} bytes of shared memory a block, mismatches={mism}")
    if key[0] != "pdd" or b.pdd_ws or launched != DIRECT_LAUNCHES_PER_RUN or mism:
        raise AssertionError(f"wide pdd: bucket {key}, pdd_ws {b.pdd_ws}, {launched} launches, "
                             f"{mism} mismatches")


def _direct_groups_vs_plain(dev, report) -> None:
    """Phase 2, the merged direct launch: every direct bucket of phase 3's
    batch (9 buckets, 1408 strips, both front ends, pdd's column sum fused)
    in the plan's one launch against its plain twin, whole arrays; timed
    with the plan's packing (CUDA events), the plain twin once."""
    import torch

    from mic_tpu_torch import MicwDecodePlan
    from mic_tpu_torch.tpu import rans_decode as rd

    name = "rans_decode_direct_groups"
    plan = MicwDecodePlan(_main_batch()[0], dev)
    groups, packing = plan._direct_groups, plan.direct_packing
    got = rd.rans_decode_direct_groups(groups, packing)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = rd.rans_decode_direct_groups_plain(groups)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = _max_abs_err(got, want)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name}: merged kernel != plain (max abs err {err})")
    ms = _cuda_ms(lambda: rd.rans_decode_direct_groups(groups, packing), 10)
    r = report[name]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    for (fn, ops, kw), g in zip(groups, got):  # each bucket's front end, pdd's column sum
        _account(r, fn.__name__, ops, (g,), 0.0, 0.0)
        if kw.get("pdd_ws"):
            r["ops"] += OPS_PER_ELEMENT[name] * g.numel()
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    from mic_tpu_torch._build import kernel_library

    blocks_sm = kernel_library().mic_direct_occupancy(packing.smem_bytes)
    print(f"kernel-vs-plain {name} {len(groups)} direct buckets, "
          f"{sum(ops[0].shape[0] for _f, ops, _k in groups)} strips in one launch "
          f"({len(packing.blocks)} blocks of up to {rd.DIRECT_STRIPS_PER_BLOCK} strips, "
          f"{packing.smem_bytes} bytes of shared memory a block, {blocks_sm} blocks an SM): "
          f"equal=True kernel_ms={ms:.3f} plain_ms={plain_ms:.3f}")
    del plan, got, want


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

    dev = torch.device("cuda", 0)
    # --- 1. setup -----------------------------------------------------------
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as ex:  # the host tier's build beside nvcc's
        host = ex.submit(_host_builds)
        lib_path = build()
        kernel_library()
        nvcc_s = time.perf_counter() - t0
        host_build = host.result()
    print(f"build: {nvcc_s:.3f} s ({lib_path.name}); host tier {host_build[2]:.3f} s "
          f"({host_build[0].name}, {host_build[1].name}); both {time.perf_counter() - t0:.3f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():  # absent when the library was built by an earlier run
        text = log.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", text))
        print(f"ptxas: {len(regs)} kernel instances, {min(regs)}-{max(regs)} registers, "
              f"{spills} bytes of spill stores")

    blobs = {k: v[0].read_bytes() for k, v in BATCH.items()}
    wrappers = {"rans_decode_zzd": (rd.rans_decode_zzd, rd.rans_decode_zzd_plain),
                "rans_decode_alias": (rd.rans_decode_alias, rd.rans_decode_alias_plain)}

    # --- 2. each kernel against its plain version, main-path shapes --------
    _clock(t_start, 2)
    report = {name: {"max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
              for name in KERNELS}
    _encode_kernels_vs_plain(dev, report)
    _rle_kernels_vs_plain(dev, report)
    post_blobs, post_expected, post_names = _post_batch(dev)
    _post_kernels_vs_plain(dev, report, post_blobs)
    _post_stage_vs_plain(dev, report, post_blobs)
    scan_blobs, scan_expected, scan_names = _scan_batch()
    _lanes_kernels_vs_plain(dev, report, scan_blobs)
    _tans_kernels_vs_plain(dev, report)
    slide = _slide()[0]
    _transform_kernels_vs_plain(dev, report, slide)
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
    _direct_groups_vs_plain(dev, report)

    # --- 3. decode path -------------------------------------------------------
    _clock(t_start, 3)
    batch, expected, timed_bytes = _main_batch()
    merged = rd.rans_decode_direct_groups
    merged.launches = 0
    merged.family_launches = dict.fromkeys(merged.family_launches, 0)
    t0 = time.perf_counter()
    plan = MicwDecodePlan(batch, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = plan.run()
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    # rows 1 and 2 count the merged launches that held their front end
    launches = {"rans_decode_direct_groups": merged.launches,
                **{n: merged.family_launches[n] for n in ("rans_decode_zzd", "rans_decode_alias")}}
    print(f"decode path: {merged.launches} direct-kernel launch(es) per plan.run() for "
          f"{len(plan._direct_keys)} direct buckets (design: {DIRECT_LAUNCHES_PER_RUN}); per "
          f"front end {merged.family_launches}")
    if merged.launches != DIRECT_LAUNCHES_PER_RUN:
        raise AssertionError(f"the decode path made {merged.launches} direct-kernel launches in "
                             f"one plan.run(), the design makes {DIRECT_LAUNCHES_PER_RUN}")
    pk = plan.direct_packing
    print(f"decode path: {_launches(pk)} (expected: {PHASE3_PACKING[0]} blocks of "
          f"{PHASE3_PACKING[1]} bytes)")
    if (len(pk.blocks), pk.smem_bytes) != PHASE3_PACKING:
        raise AssertionError(f"phase 3's packing changed: {len(pk.blocks)} blocks of "
                             f"{pk.smem_bytes} bytes")
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
    last = {}
    run_ms = _cuda_ms(lambda: last.update(out=plan.run()), 5)
    timed_mism = plan.verify_batch(last["out"], expected)
    # The launch alone, from the plan's packing (not counted: no wrapper).
    launch_ms = _cuda_ms(lambda: rd._direct_launch(plan.direct_packing), 10)
    print(f"decode path: {run_ms:.3f} ms per plan.run(), "
          f"{timed_bytes / (run_ms / 1e3) / 1e9:.3f} GB/s of decoded u16 pixels "
          f"({timed_bytes} bytes); the direct launch alone {launch_ms:.3f} ms (CUDA events); "
          f"the last timed run: mismatches={timed_mism}, {merged.launches} direct-kernel "
          f"launches in {1 + 6} runs")
    if timed_mism or merged.launches != 7 * DIRECT_LAUNCHES_PER_RUN:
        raise AssertionError(f"timed decode runs: {timed_mism} mismatches, "
                             f"{merged.launches} launches")
    del last
    launches["count_mismatches"] = _timed_runner("decode path", plan, expected, timed_bytes,
                                                 report)

    _profile(plan)
    del plan, decoded
    _wide_pdd(dev)

    # --- 4. encode path -------------------------------------------------------
    _clock(t_start, 4)
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
    _clock(t_start, 5)
    launches.update(_rle_phase(dev))

    # --- 6. post-path decode -----------------------------------------------------
    _clock(t_start, 6)
    post_launches = _post_phase(dev, post_blobs, post_expected, post_names)
    launches.update({k: post_launches[k] for k in ("rans_decode_packed", "rans_decode",
                                                   "post_decode_groups")})

    # --- 7. reference-format decode ---------------------------------------------
    _clock(t_start, 7)
    launches.update(_ref_phase(dev))

    # --- 8. RGB and WSI containers ---------------------------------------------
    _clock(t_start, 8)
    launches.update(_rgb_wsi_phase(dev, slide))

    # --- 9. wavelet -------------------------------------------------------------
    _clock(t_start, 9)
    launches.update(_wavelet_phase(dev, slide))

    # --- 10. L-lane (scan-tier) decode --------------------------------------------
    _clock(t_start, 10)
    scan = _scan_phase(dev, scan_blobs, scan_expected, scan_names, report)
    launches["count_mismatches"] += scan.pop("count_mismatches")
    launches.update(scan)

    # --- 11. multi-device ------------------------------------------------------
    _clock(t_start, 11)
    _mesh_phase(dev, scan_blobs, scan_expected)

    # --- 12. the reference writers, round-tripped through the card ------------
    _clock(t_start, 12)
    phase12, written = _writers_phase(dev)
    print(f"phase 12 launches: {phase12}")

    # --- 13. the host tier's last modules, against the card -----------------
    _clock(t_start, 13)
    for name, n in _host_tier_phase(dev).items():
        launches[name] += n

    # --- 14. the C++ host tier ---------------------------------------------------
    _clock(t_start, 14)
    print(f"phase 14 launches: {_native_phase(dev, written, host_build)}")

    # --- 15. report -----------------------------------------------------------
    _clock(t_start, 15)
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
