"""The byte, roofline and trace arithmetic on hand-computed cases."""

import types

import pytest

from portbench import devtrace, harness, roofline

CARD = {"hbm_bytes_per_s": 3.35e12}


def test_request_bytes_and_share():
    # two containers of 1000 and 500 bytes, 4 pixels: 1500 + 8 bytes
    assert roofline.request_bytes([1000, 500], 4) == 1508
    least = roofline.least_seconds(3_350_000, CARD)
    assert least == pytest.approx(1e-6)
    assert roofline.share_pct(least, 4e-6) == pytest.approx(25.0)
    assert roofline.share_pct(least, 0.0) is None
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert roofline.peaks("a card the table lacks") is None


def test_readers_on_a_hand_made_context():
    port = {("lanes_groups_kernel",): ()}
    spans = [("lanes_groups_kernel", 0.0, 1.0), ("indexSelectLargeIndex", 1.5, 2.0),
             ("index_copy", 1.9, 2.5), ("lanes_groups_kernel", 4.0, 5.0)]
    s = devtrace.summarize(spans, port)
    assert s["busy_s"] == pytest.approx(3.0)  # 1 + (0.5 + 0.5 overlapping to 2.5) + 1
    assert s["span_s"] == pytest.approx(5.0)
    assert s["gaps"] == {"host before indexselect (after lanes_groups_kernel)":
                         pytest.approx(0.5),
                         "host before lanes_groups_kernel (after indexcopy)":
                         pytest.approx(1.5)}
    ctx = {"setup_s": 12.0, "plan_stage_s": 3.0,
           "window": {"requests": 4, "pixel_bytes": 8e9, "wall_s": 2.0,
                      "latency_ms": [1.0, 2.0, 3.0, 4.0]},
           "dispatch": {"requests": 4, "dispatch_s": 0.008, "pixel_bytes": 3e9, "wall_s": 1.5},
           "trace": {**s, "port": port, "requests": 2, "wall_s": 6.0, "pixel_bytes": 6e9,
                     "request_bytes": 3.35e12 * 0.75},
           "card": CARD}

    def read(name):
        return harness.load_metric(name)(ctx)

    assert read("decode_GBps") == pytest.approx(4.0)  # 8e9 bytes over 2 s of host clock
    assert read("study_p95_ms") == pytest.approx(3.85)  # numpy's linear 95th percentile
    assert read("device_GBps") == pytest.approx(2.0)  # 6e9 bytes over 3 s busy
    assert read("setup_s") == 12.0 and read("plan_stage_s") == 3.0
    assert read("dispatch_ms") == pytest.approx(2.0)
    assert read("lanes_ms") == pytest.approx(1000.0)  # 2 s of the kernel over 2 requests
    assert read("assemble_ms") == pytest.approx(550.0)  # 0.5 + 0.6 s over 2 requests
    assert harness.load_metric("lanes_ms")({**ctx, "trace": {**ctx["trace"], "by_name": {
        "index_copy": 1.0}}}) is None
    assert read("request_roofline") == pytest.approx(25.0)  # 0.75 s least over 3 s busy
    assert read("idle_pct") == pytest.approx(50.0)  # 3 s busy of 6 s
    assert harness.load_metric("request_roofline")({**ctx, "card": None}) is None
    assert harness.load_metric("decode_GBps")({"window": {**ctx["window"], "requests": 0}}) \
        is None


def test_latency_runs_from_submit_to_the_end_of_the_request(monkeypatch):
    """On the CPU every call returns finished, so a request's latency is
    the host time of its calls, and the window's wall time covers them."""
    times = iter([0.0, 0.0, 1.0, 1.5, 2.0, 2.0, 2.25, 2.5])  # window start, 3 a request, end
    monkeypatch.setattr(harness.time, "perf_counter", lambda: next(times))
    served = harness.Served.__new__(harness.Served)
    served.path = types.SimpleNamespace(launch=lambda plan: {}, answer=lambda plan, outs: [])
    served.traffic, served.cuda, served.plans = {"in_flight": 2}, False, [object()]
    served.pixel_bytes, served.request_bytes = [100], [60]
    served.order = iter([0, 0])
    w = served.serve(requests=2)
    assert w["latency_ms"] == pytest.approx([1500.0, 250.0])
    assert w["wall_s"] == 2.5 and w["requests"] == 2 and w["pixel_bytes"] == 200
    assert w["dispatch_s"] == pytest.approx(1.75) and w["run_s"] == pytest.approx(1.0)


def test_breakdown_keeps_ten_and_all_digits():
    summary = {"by_name": {f"k{i}": i / 7 for i in range(12)},
               "gaps": {f"g{i}": i / 3 for i in range(12)}}
    b = devtrace.breakdown(summary, 0.125)
    assert len(b["device_ops"]) == 10 and b["device_ops"][0] == ["k11", 11 / 7]
    assert len(b["idle_gaps"]) == 10 and b["idle_gaps"][0] == ["g11", 11 / 3]
