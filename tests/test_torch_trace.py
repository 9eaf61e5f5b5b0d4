"""The port's tracer (``mic_tpu_torch/trace.py``) and the spans and
counters the decode plan records, on the CPU.

* The tracer alone: spans nest with the right parent and request ids,
  each thread keeps its own stack, a span's start plus the anchor lies on
  ``time.time_ns()``'s clock, and off it records nothing.
* A scan plan of the repository's CT slice (``portbench/data``, written
  at 8 lanes with FF 41, as the benchmark's ``scan8`` mix writes it):
  ``plan.parse``, ``plan.tables`` and ``plan.upload`` inside
  ``plan.stage``, the staging's work inside them, the ``strips.*``
  counters against the plan's buckets, ``work_bytes.lanes`` against the
  container's own strip table, the gather plan built at the first
  ``assemble_device`` only, and nothing recorded with tracing off.
* A plan of four crops of the slice, one a route (direct, r-mode, and
  two post): ``work_bytes.direct``, ``.rle`` and ``.post`` against the
  containers' strip tables and MICT headers.
"""

import struct
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from mic_tpu_torch import _build, trace
from mic_tpu_torch.tpu import strips as S

CT = Path(__file__).resolve().parents[1] / "portbench" / "data" / "CT_512_512_image.raw"
STUDY = 4  # slices of the staged study, each its own container object
THREADS = 16  # threads of the counting test, whatever the machine's cores
# (predictor, entropy) of each crop of the mixed plan, and the kernel that
# decodes its strips: the direct kernel alone, the r-kernel alone, or the
# direct kernel's symbols then the post kernel
MIXED = {("zzd", "standard"): "direct", ("zzr", "alias"): "rle",
         ("zz", "standard"): "post", ("avg", "alias"): "post"}


@pytest.fixture
def tracing():
    """Tracing on for one test, and off with nothing left after it."""
    trace.take()
    trace.enable()
    yield
    trace.disable()
    trace.take()


@pytest.fixture(scope="module")
def ct():
    """The CT slice and its container: 8 lanes, FF 41, auto-fast."""
    px = np.fromfile(CT, dtype="<u2")
    blob = S.micw_compress(px, 512, 512, int(px.max()), lanes=8, predictor="auto-fast",
                           entropy="alias")
    return SimpleNamespace(px=px, blob=blob)


@pytest.fixture(scope="module")
def traced(ct):
    """A study staged, and a one-slice plan run once and assembled twice,
    with tracing on: what each phase recorded."""
    trace.take()
    trace.enable()
    try:
        study = S.MicwDecodePlan([bytes(bytearray(ct.blob)) for _ in range(STUDY)], "cpu",
                                 scan=True)
        staged = trace.take()
        plan = S.MicwDecodePlan([ct.blob], "cpu", scan=True)
        one = trace.take()
        with trace.request(1):
            outs = plan.run()
            first = plan.assemble_device(outs)
        with trace.request(2):
            plan.assemble_device(outs)
        served = trace.take()
    finally:
        trace.disable()
        trace.take()
    return SimpleNamespace(study=study, staged=staged, plan=plan, one=one, served=served,
                           first=first)


@pytest.fixture(scope="module")
def mixed(ct):
    """Four 256x64 crops of the slice, one container a route of
    :data:`MIXED`, staged as one plan and run once with tracing on."""
    crop = np.ascontiguousarray(ct.px.reshape(512, 512)[200:264, 128:384]).ravel()
    blobs = [S.micw_compress(crop, 256, 64, int(crop.max()), predictor=p, entropy=e)
             for p, e in MIXED]
    trace.take()
    trace.enable()
    try:
        plan = S.MicwDecodePlan(blobs, "cpu")
        staged = trace.take()
        images = plan.assemble_device(plan.run())
        served = trace.take()
    finally:
        trace.disable()
        trace.take()
    return SimpleNamespace(crop=crop, blobs=blobs, plan=plan, staged=staged, served=served,
                           images=images)


def _named(spans, name):
    return [s for s in spans if s.name == name]


# -- the tracer alone --------------------------------------------------------


@pytest.mark.parametrize("rid", [None, 7, "study-3"])
def test_spans_nest_with_parent_and_request(tracing, rid):
    def body():
        with trace.span("outer", a=1):
            with trace.span("inner"):
                trace.count("n", 2)
            with trace.span("sibling"):
                pass

    if rid is None:
        body()
    else:
        with trace.request(rid):
            body()
    spans, counts = trace.take()
    by = {s.name: s for s in spans}
    top = by["request"].id if rid is not None else 0
    assert by["outer"].parent == top and by["outer"].attrs == {"a": 1}
    assert by["inner"].parent == by["outer"].id == by["sibling"].parent
    assert all(s.request == rid for s in spans)
    assert len({s.id for s in spans}) == len(spans)
    for s in spans:
        assert s.start <= s.end
    assert by["outer"].start <= by["inner"].start <= by["inner"].end <= by["sibling"].start
    assert by["sibling"].end <= by["outer"].end
    assert counts["n"] == 2
    assert trace.take() == ([], {})


def test_each_thread_keeps_its_own_stack(tracing):
    def worker():
        with trace.request("w"):
            with trace.span("in_thread"):
                pass

    with trace.request("main"):
        with trace.span("in_main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    spans, _ = trace.take()
    by = {(s.name, s.request): s for s in spans}
    assert by[("in_thread", "w")].parent == by[("request", "w")].id
    assert by[("request", "w")].parent == 0
    assert by[("in_main", "main")].parent == by[("request", "main")].id


def test_threads_lose_no_count_or_span(tracing):
    """Many threads, switching as often as the interpreter allows: every
    count and every span is kept."""
    threads, each = THREADS, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                trace.count("hits")
                with trace.span("s"):
                    pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    spans, counts = trace.take()
    assert counts["hits"] == threads * each and len(spans) == threads * each
    assert len({s.id for s in spans}) == len(spans)


def test_anchor_puts_spans_on_the_wall_clock(tracing):
    before = time.time_ns()
    with trace.span("x"):
        pass
    after = time.time_ns()
    (s,), _ = trace.take()
    slack = 2_000_000  # 2 ms: the two clocks are read one after the other
    assert before - slack <= s.start + trace.anchor_ns() <= s.end + trace.anchor_ns() \
        <= after + slack


@pytest.mark.parametrize("ctx", ["span", "request"])
def test_off_is_one_shared_no_op(ctx):
    trace.disable()
    trace.take()
    a = trace.span("a", k=1) if ctx == "span" else trace.request(1)
    assert a is trace.span("b") is trace.request(2)
    with a as opened:
        assert opened is None
        trace.count("c")
    assert trace.take() == ([], {})


def test_counters_is_a_snapshot(tracing):
    """``counters()`` copies what was counted and leaves it for ``take()``;
    the wrappers' own ``.launches`` are not among the counters."""
    from mic_tpu_torch.tpu import scan_decode

    trace.count("x", 3)
    snap = trace.counters()
    assert snap == {"x": 3}
    snap["x"] = 0
    scan_decode.rans_decode_lanes_groups.launches += 2  # as two launches would
    try:
        trace.count("x")
        assert trace.counters() == {"x": 4}
        assert trace.take() == ([], {"x": 4})
        assert trace.counters() == {} and trace.take() == ([], {})
    finally:
        scan_decode.rans_decode_lanes_groups.launches -= 2


def test_library_load_and_encode_spans(tracing):
    _build.host_library.cache_clear()
    _build.host_library()
    px = np.arange(128 * 16, dtype=np.uint16).reshape(16, 128) % 97
    S.micw_compress(px.ravel(), 128, 16, 96, lanes=8)
    spans, _ = trace.take()
    (load,) = _named(spans, "lib.load")
    assert load.attrs["library"] == "host" and isinstance(load.attrs["built"], bool)
    assert len(_named(spans, "encode")) == 1


# -- the decode plan's spans and counters ------------------------------------


@pytest.mark.parametrize("name", ["plan.parse", "plan.tables", "plan.upload"])
def test_staging_parts_lie_inside_plan_stage(traced, name):
    spans = traced.staged[0]
    (stage,) = _named(spans, "plan.stage")
    parts = _named(spans, name)
    assert parts
    for s in parts:
        assert s.parent == stage.id and stage.start <= s.start <= s.end <= stage.end
    assert stage.attrs == {"strips": sum(len(k) for k in traced.study.keys_per_blob),
                           "buckets": len(traced.study.buckets)}


# the staging's work, by the part of plan.stage that must hold each call
STAGING_WORK = {
    "plan.parse": ("micw_parse", "mict_parse", "_strip_bucket"),
    "plan.tables": ("build_lane_operands", "build_alias_bucket_tables", "build_packed_tables",
                    "build_pallas_tables", "_rle_sizing", "_post_sizing"),
    "plan.upload": ("lane_tensors", "to_device", "DirectPacking", "RlePacking",
                    "LanesPacking", "PostPacking"),
}


@pytest.mark.parametrize("part", list(STAGING_WORK))
def test_staging_parts_cover_plan_stage(ct, monkeypatch, tracing, part):
    """Every call of the staging's parsers, table builders and copies to
    the device, in a scan study of the slice and in the mixed plan, lies
    inside a span of its part of ``plan.stage``: what the parts leave out
    is the plan's bookkeeping.  (The share the parts cover is a reading of
    the card machine's staging, not a test.)"""
    calls = []

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                calls.append((name, t0, time.perf_counter_ns()))
        return call

    for names in STAGING_WORK.values():
        for name in names:
            monkeypatch.setattr(S, name, timed(name, getattr(S, name)))
    crop = np.ascontiguousarray(ct.px.reshape(512, 512)[200:264, 128:384]).ravel()
    S.MicwDecodePlan([bytes(bytearray(ct.blob)) for _ in range(2)], "cpu", scan=True)
    S.MicwDecodePlan([S.micw_compress(crop, 256, 64, int(crop.max()), predictor=p, entropy=e)
                      for p, e in MIXED], "cpu")
    spans, _ = trace.take()
    stages = _named(spans, "plan.stage")
    parts = _named(spans, part)
    assert len(stages) == 2 and parts
    assert all(any(s.id == p.parent for s in stages) for p in parts)
    mine = [c for c in calls if c[0] in STAGING_WORK[part]]
    assert mine
    for name, t0, t1 in mine:
        assert any(p.start <= t0 <= t1 <= p.end for p in parts), name
    # the parts do not overlap: a call lies in one part only
    for name, t0, t1 in calls:
        if name not in STAGING_WORK[part]:
            assert not any(p.start <= t0 <= t1 <= p.end for p in parts), name


@pytest.mark.parametrize("which", ["study", "one"])
def test_strip_counters_match_the_buckets(traced, which):
    plan = traced.study if which == "study" else traced.plan
    counts = dict((traced.staged if which == "study" else traced.one)[1])
    # not a route: the scan strips that read their bucket tables (every
    # strip of this FF 41 container at 8 lanes)
    assert counts.pop("strips.scan_alias_buckets") == counts["strips.scan_fused"] == sum(
        b.alias_strips for b in plan.buckets.values())
    strips = {k: v for k, v in counts.items() if k.startswith("strips.")}
    assert sum(strips.values()) == sum(len(k) for k in plan.keys_per_blob)
    want: dict = {}
    for k, b in plan.buckets.items():
        assert k[0] == "scan"
        route = "strips.scan_post" if b.post is not None else "strips.scan_fused"
        want[route] = want.get(route, 0) + b.n
    for st in plan.raw_strips:
        r = "strips.const" if st[5] == S.STRIP_MODE_CONST else "strips.raw"
        want[r] = want.get(r, 0) + 1
    assert strips == want


def test_bucket_counter_reads_zero_for_ff57_strips(ct, tracing):
    """``strips.scan_alias_buckets`` counts only FF 41 strips: a scan plan
    of the slice's FF 57 container at 8 lanes reads 0."""
    crop = np.ascontiguousarray(ct.px.reshape(512, 512)[200:264, 128:384]).ravel()
    blob = S.micw_compress(crop, 256, 64, int(crop.max()), lanes=8, predictor="auto-fast",
                           entropy="standard")
    plan = S.MicwDecodePlan([blob], "cpu", scan=True)
    _spans, counts = trace.take()
    assert counts["strips.scan_alias_buckets"] == 0
    assert counts.get("strips.scan_fused", 0) + counts.get("strips.scan_post", 0) == sum(
        b.n for b in plan.buckets.values())


def _strip_table(blob):
    """(MICT bytes, pixels) of each entropy strip, from the container's own
    header and strip table."""
    width, height, n, strip_h = struct.unpack_from("<IIII", blob, 4)
    out = []
    for i in range(n):
        _off, ln, _soa, _tok, _runs, _same, mode = struct.unpack_from(
            "<IIIIIII", blob, 24 + 28 * i)
        if mode not in (1, 5):  # raw and constant strips take no kernel
            out.append((ln, width * min(strip_h, height - i * strip_h)))
    return out


def test_work_bytes_lanes_is_the_format_count(traced, ct):
    table = _strip_table(ct.blob)
    want = sum(ln for ln, _px in table) + 2 * sum(px for _ln, px in table)
    assert traced.plan.work_bytes == {"lanes": want}
    assert traced.served[1]["work_bytes.lanes"] == want  # one run
    (run,) = _named(traced.served[0], "plan.run")
    (lanes,) = _named(traced.served[0], "run.lanes")
    assert lanes.parent == run.id and lanes.attrs == {"launches": 0}  # no launch on the CPU
    assert len(_named(traced.served[0], "run.finish")) == 1


@pytest.mark.parametrize("request_id", [1, 2])
def test_gather_plan_at_the_first_assemble_only(traced, ct, request_id):
    spans, counts = traced.served
    mine = [s for s in spans if s.request == request_id]
    (asm,) = _named(mine, "plan.assemble")
    for name in ("assemble.gathers", "assemble.images"):
        (s,) = _named(mine, name)
        assert s.parent == asm.id
    plans = _named(mine, "assemble.gather_plan")
    assert len(plans) == (1 if request_id == 1 else 0)
    assert counts["assemble.gather_plans"] == 1
    assert _named(mine, "assemble.images")[0].attrs == {"images": 1}
    px, w, h = traced.first[0]
    assert (w, h) == (512, 512) and np.array_equal(px.numpy().view(np.uint16), ct.px)


def test_nothing_recorded_with_tracing_off(ct):
    trace.disable()
    trace.take()
    plan = S.MicwDecodePlan([ct.blob], "cpu", scan=True)
    with trace.request(3):
        plan.assemble_device(plan.run())
    assert trace.take() == ([], {})


def _mixed_want(blobs):
    """Each kernel's bytes of the mixed plan, from the containers' own
    strip tables and MICT headers: a strip's MICT bytes read once and 2 x
    its pixels written once, or 2 x its symbols (the MICT header's count)
    written by the direct kernel and read by the post kernel."""
    want = {"direct": 0, "rle": 0, "post": 0}
    for blob, kernel in zip(blobs, MIXED.values()):
        width, height, n, strip_h = struct.unpack_from("<IIII", blob, 4)
        data0 = 24 + 28 * n
        for i in range(n):
            off, ln, _soa, _tok, _runs, _same, mode = struct.unpack_from(
                "<IIIIIII", blob, 24 + 28 * i)
            if mode in (1, 5):  # raw and constant strips take no kernel
                continue
            pixels = width * min(strip_h, height - i * strip_h)
            if kernel == "post":
                (symbols,) = struct.unpack_from("<I", blob, data0 + off + 4)
                want["direct"] += ln + 2 * symbols
                want["post"] += 2 * symbols + 2 * pixels
            else:
                want[kernel] += ln + 2 * pixels
    return want


@pytest.mark.parametrize("kernel", ["direct", "rle", "post"])
def test_work_bytes_of_the_mixed_plan_are_the_format_count(mixed, kernel):
    want = _mixed_want(mixed.blobs)[kernel]
    assert want > 0
    assert mixed.plan.work_bytes[kernel] == want
    spans, counts = mixed.served
    assert counts[f"work_bytes.{kernel}"] == want  # one run
    (run,) = _named(spans, "plan.run")
    (sp,) = _named(spans, f"run.{kernel}")
    assert sp.parent == run.id and sp.attrs == {"launches": 0}  # no launch on the CPU
    assert set(mixed.plan.work_bytes) == {"direct", "rle", "post"}
    for px, w, h in mixed.images:
        assert (w, h) == (256, 64) and np.array_equal(px.numpy().view(np.uint16), mixed.crop)


def test_strip_counters_of_the_mixed_plan_name_each_route(mixed):
    _spans, counts = mixed.staged
    strips = {k: v for k, v in counts.items() if k.startswith("strips.")}
    assert sum(strips.values()) == sum(len(k) for k in mixed.plan.keys_per_blob)
    want: dict = {}
    for keys, kernel in zip(mixed.plan.keys_per_blob, MIXED.values()):
        for key, i in keys:
            route = kernel
            if key == "raw":
                route = ("const" if mixed.plan.raw_strips[i][5] == S.STRIP_MODE_CONST
                         else "raw")
            want[f"strips.{route}"] = want.get(f"strips.{route}", 0) + 1
    assert strips == want
