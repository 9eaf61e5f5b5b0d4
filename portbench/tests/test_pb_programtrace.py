"""The readers of the program's spans and counters (``programtrace.py``
and its metrics) on hand-made spans and gaps, the trace clock's markers
(``devtrace.py``), the program's stretch on the CPU beside the harness's
two, a ``--trace 1`` run on the CPU, and on the card the program's clock
against the trace's."""

import copy
import os
import time

import pytest
import torch

from mic_tpu_torch.trace import Span
from portbench import check, devtrace, harness, programtrace, studies

from .conftest import cuda_or_skip

CARD = {"hbm_bytes_per_s": 3.35e12}
MS = 1_000_000  # ns


def _span(name, sid, parent, start_ms, end_ms, request=None, **attrs):
    return Span(name, request, sid, parent, int(start_ms * MS), int(end_ms * MS), attrs)


def _program():
    """Set-up: two plans staged (parse, tables, upload inside each stage).
    The stretch: two requests of 10 ms each on the program's clock, the
    anchor 1000 ms, so request 0 runs 1000-1010 ms on the wall clock."""
    setup = [_span("plan.parse", 2, 1, 0, 1), _span("plan.tables", 3, 1, 1, 7),
             _span("plan.upload", 4, 1, 7, 8), _span("plan.stage", 1, 0, 0, 8.5),
             _span("plan.parse", 6, 5, 10, 11.5), _span("plan.tables", 7, 5, 11.5, 15),
             _span("plan.upload", 8, 5, 15, 16), _span("plan.stage", 5, 0, 10, 16)]
    spans = []
    for r in range(2):
        b, i = 10 * r, 100 * (r + 1)
        spans += [_span("run.lanes", i + 3, i + 2, b + 0.5, b + 1.0, r, launches=1),
                  _span("plan.run", i + 2, i + 1, b + 0.2, b + 1.5, r),
                  _span("assemble.images", i + 5, i + 4, b + 2.5, b + 8.0, r, images=4),
                  _span("plan.assemble", i + 4, i + 1, b + 2.0, b + 8.5, r),
                  _span("request", i + 1, 0, b + 0.1, b + 9.0, r)]
    # the lanes kernel 1.5-5.5 ms into each request, a gather 8.6-9.6
    records = []
    for r in range(2):
        w = 1000 + 10 * r
        records += [("lanes_groups_kernel", (w + 1.5) * MS, (w + 5.5) * MS),
                    ("indexSelectLargeIndex", (w + 8.6) * MS, (w + 9.6) * MS)]
    stretch = {"requests": 2, "wall_s": 0.02, "dispatch_s": 0.0167, "spans": spans,
               "counts": {"work_bytes.lanes": 2 * 6_700_000, "strips.scan_fused": 16},
               "records": records, "anchor_ns": 1000 * MS, "start_ns": 1000 * MS,
               "end_ns": 1020 * MS}
    return programtrace.program_ctx((setup, {"strips.scan_fused": 16}), stretch)


EXPECTED = {"stage_parse_s": 2.5e-3, "stage_tables_s": 9.5e-3, "stage_upload_s": 2e-3,
            "run_host_ms": 1.3, "assemble_host_ms": 6.5,
            # 13.4 MB at 3.35 TB/s = 4 us, over 8 ms of the kernel
            "lanes_roofline": 0.05}


@pytest.mark.parametrize("name", list(EXPECTED))
def test_reader_on_hand_made_spans(name):
    ctx = {"program": _program(), "card": CARD}
    assert harness.load_metric(name)(ctx) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("kernel", ["direct", "rle", "lanes", "post"])
def test_kernel_roofline_reads_its_own_kernel(kernel):
    """Each kernel's work over its own records' device seconds: 33.5 MB at
    3.35 TB/s is 10 us, over 1, 2, 4 or 8 ms of the kernel's records."""
    ms = {"direct": 1, "rle": 2, "lanes": 4, "post": 8}
    records = [(f"void {name}<8>(Args)", 0, ms[k] * MS)
               for k in ms for name in programtrace.RUN_KERNELS[f"run.{k}"]]
    p = _program()
    p["stretch"]["records"] = records
    p["stretch"]["counts"] = {f"work_bytes.{k}": 33_500_000 for k in ms}
    n_names = len(programtrace.RUN_KERNELS[f"run.{kernel}"])
    want = 100 * 10e-6 / (n_names * ms[kernel] * 1e-3)
    assert harness.load_metric(f"{kernel}_roofline")({"program": p, "card": CARD}) \
        == pytest.approx(want)


PROGRAM_METRICS = ["stage_parse_s", "stage_tables_s", "stage_upload_s", "run_host_ms",
                   "assemble_host_ms", "direct_roofline", "rle_roofline", "lanes_roofline",
                   "post_roofline"]


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_reader_finds_nothing_without_the_program(name):
    """A parent without the tracer: no ``program`` in the context."""
    ctx = {"setup_s": 1.0, "plan_stage_s": 0.5, "card": CARD,
           "trace": {"requests": 2, "by_name": {"lanes_groups_kernel": 1.0}, "busy_s": 1.0}}
    assert harness.load_metric(name)(ctx) is None
    assert harness.load_metric(name)({**ctx, "program": None}) is None


def test_lanes_roofline_finds_nothing_without_work_or_kernel():
    p = _program()
    p["stretch"]["counts"] = {}
    assert harness.load_metric("lanes_roofline")({"program": p, "card": CARD}) is None
    p = _program()
    p["stretch"]["records"] = [r for r in p["stretch"]["records"] if "lanes" not in r[0]]
    assert harness.load_metric("lanes_roofline")({"program": p, "card": CARD}) is None
    assert harness.load_metric("lanes_roofline")({"program": _program(), "card": None}) is None


def test_device_gaps_and_idle_by_span():
    st = _program()["stretch"]
    gaps = programtrace.device_gaps(st["records"], st["start_ns"], st["end_ns"])
    assert gaps == [(1000 * MS, 1001.5 * MS), (1005.5 * MS, 1008.6 * MS),
                    (1009.6 * MS, 1011.5 * MS), (1015.5 * MS, 1018.6 * MS),
                    (1019.6 * MS, 1020 * MS)]
    idle = programtrace.idle_by_span(gaps, st["spans"], st["anchor_ns"])
    # request 0, first gap: 0-0.1 ms outside, 0.1-0.2 in the caller, 0.2-0.5
    # plan.run, 0.5-1.0 run.lanes, 1.0-1.5 plan.run; second gap: 5.5-8.0
    # assemble.images, 8.0-8.5 plan.assemble, 8.5-8.6 in the caller; 9.6-10.1
    # outside; request 1 the same; the last gap, 19.6-20, outside
    want = {"outside the program": 1.0e-3, "request, in the caller": 0.4e-3,
            "plan.run": 1.6e-3, "run.lanes": 1.0e-3, "assemble.images": 5.0e-3,
            "plan.assemble": 1.0e-3}
    assert idle.keys() == want.keys()
    for k in want:
        assert idle[k] == pytest.approx(want[k]), k
    assert sum(idle.values()) == pytest.approx(sum(b - a for a, b in gaps) * 1e-9)


def test_idle_by_span_names_the_innermost_of_nested_spans():
    spans = [_span("outer", 1, 0, 0, 10), _span("mid", 2, 1, 2, 8), _span("inner", 3, 2, 4, 5)]
    idle = programtrace.idle_by_span([(1 * MS, 9 * MS)], spans, 0)
    assert idle == pytest.approx({"outer": 2e-3, "mid": 5e-3, "inner": 1e-3})


def test_host_spans_rank_by_self_time():
    st = _program()["stretch"]
    top = dict(programtrace.host_spans(st["spans"]))
    assert top["assemble.images"] == pytest.approx(2 * 5.5e-3)
    assert top["plan.assemble"] == pytest.approx(2 * 1.0e-3)  # 6.5 less its child's 5.5
    assert top["plan.run"] == pytest.approx(2 * 0.8e-3)
    assert top["request"] == pytest.approx(2 * (8.9 - 1.3 - 6.5) * 1e-3)
    assert [n for n, _s in programtrace.host_spans(st["spans"])][0] == "assemble.images"
    assert len(programtrace.host_spans(st["spans"], top=2)) == 2


def test_clock_violations_pair_launches_with_records():
    st = _program()["stretch"]
    assert programtrace.clock_violations(st["records"], st["spans"], st["anchor_ns"]) == 0
    # the card's clock 1.2 ms behind the program's: each record before its span
    late = [(n, s - 1.2 * MS, e - 1.2 * MS) for n, s, e in st["records"]]
    assert programtrace.clock_violations(late, st["spans"], st["anchor_ns"]) == 2
    # a launch with no record, and a span that launched twice
    assert programtrace.clock_violations(st["records"][:1], st["spans"], st["anchor_ns"]) == 1
    two = [s._replace(attrs={"launches": 2}) if s.name == "run.lanes" else s
           for s in st["spans"]]
    assert programtrace.clock_violations(st["records"], two, st["anchor_ns"]) == 2
    b = programtrace.breakdown(_program())
    assert b["host_spans"][0][0] == "assemble.images"
    assert b["idle_by_span"][0] == ["assemble.images", pytest.approx(5e-3)]


def test_markers_measure_the_trace_clock():
    """Markers whose records sit 100 us early before the work and 120 us
    early after it: the error at each, and the records in between moved
    by the error interpolated at their start."""
    before = [(10_000 * i, 10_000 * i + 14_000) for i in range(3)]
    after = [(1_000_000 + 10_000 * i, 1_000_000 + 10_000 * i + 14_000) for i in range(3)]
    marks = [("neg", t0 + 7_000 - 100_000, t0 + 9_000 - 100_000) for t0, _t1 in before] \
        + [("neg", t0 + 7_000 - 120_000, t0 + 9_000 - 120_000) for t0, _t1 in after]
    work = [("lanes_groups_kernel", 400_000, 450_000)]
    raw = sorted(marks + work, key=lambda r: r[1])
    at, off, records = devtrace.clock_offsets(raw, before, after)
    assert off == (-100_000, -120_000) and records == work
    assert at == (-83_000, 897_000)  # the markers' middle records
    ((name, s, e),) = devtrace.on_host_clock(records, at, off)
    shift = 100_000 + 20_000 * (400_000 + 83_000) / 980_000
    assert name == "lanes_groups_kernel"
    assert s == pytest.approx(400_000 + shift, abs=1) and e - s == 50_000
    with pytest.raises(ValueError):
        devtrace.clock_offsets(raw[1:], before, after)


def test_profiled_places_the_records_on_the_wall_clock(monkeypatch):
    """The profiler session's seconds from the trace's start, placed by the
    markers before the work and corrected by those after: a trace whose
    clock starts at 5 s of the wall clock (ns) and drifts 20 us, linearly,
    between the markers' middles (17 us and 1037 us of its own clock)
    gives the kernel's wall-clock times back, and reads an error of 0
    before and the drift after."""
    base = 5_000_000_000
    first = [(base + 10_000 * i, base + 10_000 * i + 14_000) for i in range(3)]
    last = [(base + 1_000_000 + 10_000 * i, base + 1_000_000 + 10_000 * i + 14_000)
            for i in range(3)]
    marks = iter([first, last])
    monkeypatch.setattr(devtrace, "_markers", lambda x, n: next(marks))

    def fake(fn):
        # each marker's kernel at the middle of its call, the late ones
        # 20 us late on the trace's clock; the kernel at 410-460 us of it
        at = [(t0 + t1) // 2 - base for t0, t1 in first] + [
            (t0 + t1) // 2 - base + 20_000 for t0, t1 in last]
        spans = [("neg", t / 1e9, (t + 2_000) / 1e9) for t in at]
        spans.append(("lanes_groups_kernel", 410_000 / 1e9, 460_000 / 1e9))
        return fn(), sorted(spans, key=lambda sp: sp[1])

    monkeypatch.setattr(devtrace, "_profiled", fake)
    out, records, off = devtrace._placed(lambda: "done", "cpu")
    assert out == "done" and off[0] == 0 and off[1] == pytest.approx(20_000, abs=1)
    ((name, start, end),) = records
    assert name == "lanes_groups_kernel" and end - start == 50_000
    drift = 20_000 * (410_000 - 17_000) / (1_037_000 - 17_000)
    assert start == pytest.approx(base + 410_000 - drift, abs=1)


def test_stretch_leaves_the_harness_stretches_alone(small_root):
    """On the CPU: the harness's two stretches, the existing readers and
    devtrace's outputs read the same before and after the program's
    stretch, which records the program's spans and counters, each request
    inside its own ``request`` span."""
    bench = harness.load_benchmark()
    cell = bench["workloads"][0]
    config = harness.load_config(cell["config"], small_root)
    traffic = harness.load_traffic(cell["traffic"], small_root)
    served = harness.Served(config, traffic, 3_000_000_019, torch.device("cpu"), small_root)
    sample = check.Sample(studies.sample_rng(3), 2)
    ctx = {"setup_s": 1.0, "plan_stage_s": served.plan_stage_s, "card": CARD}
    ctx["dispatch"] = served.serve(requests=2, sample=sample)
    stretch, records, off = harness._traced(served, lambda: served.serve(requests=2,
                                                                         sample=sample))
    assert records == [] and off is None  # no trace on the CPU
    port = devtrace.port_kernels()
    summary = devtrace.summarize(devtrace.in_seconds(records), port)
    ctx["trace"] = {**stretch, **summary, "port": port}
    names = [m["name"] for m in harness.cell_metrics(bench, cell["name"], True)]
    before = {n: harness.load_metric(n)(ctx) for n in names}
    kept = copy.deepcopy({k: ctx[k] for k in ("dispatch", "trace")})
    b0 = devtrace.breakdown(summary, 0.0)
    trace = programtrace.tracer()
    program = programtrace.program_stretch(*harness._traced(
        served, lambda: programtrace.serve_traced(served, trace, 2)))
    ctx["program"] = programtrace.program_ctx(([], {}), program)
    assert {n: harness.load_metric(n)(ctx) for n in names
            if n not in PROGRAM_METRICS} == {n: v for n, v in before.items()
                                             if n not in PROGRAM_METRICS}
    assert {k: ctx[k] for k in ("dispatch", "trace")} == kept
    assert devtrace.breakdown(summary, 0.0) == b0
    assert program["requests"] == 2 and program["records"] == []
    assert sorted({s.request for s in program["spans"]}) == [0, 1]
    assert sorted(s.request for s in program["spans"] if s.name == "request") == [0, 1]
    assert {"plan.run", "run.lanes", "plan.assemble", "request"} <= {s.name for s in
                                                                    program["spans"]}
    assert program["counts"]["work_bytes.lanes"] > 0
    assert programtrace.span_seconds(program["spans"], "plan.run") + programtrace.span_seconds(
        program["spans"], "plan.assemble") <= program["dispatch_s"]


def test_trace_run_on_the_cpu_reports_the_program_metrics(small_root, monkeypatch, capsys):
    """On the CPU: a ``--trace 1`` run records the program's spans through
    set-up and serves a third stretch of the same length, each request in
    its own span, whose requests count as attempted.  Its line holds each
    per-layer metric whose reader finds something: the staging parts and
    the host's two spans; no roofline, since the CPU has no peaks and no
    trace.  The breakdown names the host's spans and the stretch's note
    its clock check."""
    monkeypatch.setattr(harness, "TRACE_REQUESTS", 2)
    bench = harness.load_benchmark()
    cell = bench["workloads"][0]["name"]
    line, numbers = harness.run_cell(bench, cell, 3_000_000_019, 0.0, True,
                                     torch.device("cpu"), time.perf_counter(), small_root)
    assert line["correct"] is True and numbers == {k: 0 for k in numbers}
    assert line["attempted"] == 3 * 2
    names = {m["name"] for m in harness.cell_metrics(bench, cell, True)}
    new = {"stage_parse_s", "stage_tables_s", "stage_upload_s", "run_host_ms",
           "assemble_host_ms", "lanes_roofline"}
    assert new <= names
    reported = set(line["metrics"])
    assert reported & new == new - {"lanes_roofline"}
    assert all(line["metrics"][n]["value"] > 0 for n in new - {"lanes_roofline"})
    assert {"host_spans", "idle_by_span", "device_ops", "idle_gaps"} <= set(line["breakdown"])
    assert line["breakdown"]["host_spans"] and line["breakdown"]["idle_by_span"] == []
    assert list(line)[-1] == "compared"
    err = capsys.readouterr().err
    assert "program stretch: clock_violations 0" in err and "program set-up: spans" in err
    assert not programtrace.tracer().counters()  # tracing is off and taken


def _process_age_s() -> float:
    """Seconds since this process started, from /proc."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


@pytest.mark.cuda
def test_a_span_holds_its_launch_on_the_card():
    """In a process older than a minute (where CUPTI's timestamps drifted
    before the teardown), a span around one launch of the lanes kernel and
    its synchronise holds the kernel's record, both on the wall clock."""
    device = cuda_or_skip()
    from mic_tpu_torch import trace
    from mic_tpu_torch.tpu import scan_decode as sd
    from mic_tpu_torch.tpu.strips import MicwDecodePlan, micw_compress

    age = _process_age_s()
    if age < 61:
        time.sleep(61 - age)
    px = studies.source_slice(harness.load_config("ct_512_study")).ravel()
    blob = micw_compress(px, 512, 512, int(px.max()), lanes=8, predictor="auto-fast",
                         entropy="alias")
    plan = MicwDecodePlan([blob], device, scan=True)
    plan.run()
    torch.cuda.synchronize()
    trace.take()
    trace.enable()
    try:
        def launch():
            with trace.span("launch"):
                sd.rans_decode_lanes_groups(plan._scan_groups, plan.scan_packing)
                torch.cuda.synchronize()

        _out, records, off = devtrace.profiled(launch, device)
        (span,), _counts = trace.take()
        anchor = trace.anchor_ns()
    finally:
        trace.disable()
    names = programtrace.RUN_KERNELS["run.lanes"]
    lanes = [r for r in records if any(n in r[0] for n in names)]
    assert len(lanes) == plan.scan_packing.n_launches == 1
    (_name, start, end), = lanes
    assert span.start + anchor <= start <= end <= span.end + anchor, (
        span.start + anchor - start, end - span.end - anchor, off)
    print(f"trace clock's error {off[0] / 1e3:.1f} / {off[1] / 1e3:.1f} us; the kernel "
          f"{(start - span.start - anchor) / 1e3:.1f} us into its span")
