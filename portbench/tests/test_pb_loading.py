"""Configurations, mixes and metric readers are found by name, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import re
import time

import pytest

from portbench import harness

from .conftest import CPU_SECONDS, REPO

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
        config = harness.load_config(c["name"])
        assert config["name"] == c["name"]
        assert sorted(config["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads_entries():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        harness.load_config(w["config"])
        traffic = harness.load_traffic(w["traffic"])
        assert traffic["name"] == w["traffic"]
        e2e = [m["name"] for m in harness.cell_metrics(BENCH, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(BENCH, w["name"], True)


def test_metric_entries_and_readers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(harness.load_metric(m["name"]))
        assert harness.load_metric(m["name"])({"setup_s": 1.0, "plan_stage_s": 0.5}) in (
            None, 1.0, 0.5)


def test_run_seconds_fit_the_check():
    """2 + 14 runs a cell for 24 cells, each run_seconds + 60, each cell
    2 x 90 to compile, 1200 spare: within 43200 seconds."""
    cells = 24
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_new_files_are_found_without_edits(small_root):
    """A new configuration, mix, metric reader and cell take new files and
    entries only."""
    (small_root / "configs" / "ct_512_copy.json").write_text(
        (small_root / "configs" / "ct_512_study.json").read_text().replace(
            '"ct_512_study"', '"ct_512_copy"'))
    fast = json.loads((small_root / "traffic" / "fast.json").read_text())
    fast.update(name="fast_standard", entropy="standard")
    (small_root / "traffic" / "fast_standard.json").write_text(json.dumps(fast))
    (small_root / "metrics" / "requests_served.py").write_text(
        "def read(ctx):\n    w = ctx.get('window')\n    return w['requests'] if w else None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "ct_standard", "config": "ct_512_copy",
                               "traffic": "fast_standard", "chips": 1, "why": "a test cell"})
    bench["end_to_end"].append({"name": "requests_served", "unit": "requests",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["ct_standard"]})
    result, _numbers = harness.run_cell(bench, "ct_standard", 5, 2.0, False, "cpu",
                                        time.perf_counter(), small_root)
    assert result["correct"]
    assert result["metrics"]["requests_served"]["value"] == result["attempted"] > 0
    assert set(result["metrics"]) == {"decode_GBps", "study_p95_ms", "setup_s",
                                      "requests_served"}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_runs_on_the_cpu(small_root, workload, monkeypatch):
    """An untraced run never turns the program's tracing on."""
    from mic_tpu_torch import trace

    monkeypatch.setattr(trace, "enable", lambda: pytest.fail("tracing on in an untraced run"))
    result, numbers = harness.run_cell(BENCH, workload, 2**31 + 11, CPU_SECONDS, False, "cpu",
                                       time.perf_counter(), small_root)
    assert result["correct"] and numbers == {k: 0 for k in numbers}
    assert list(result)[-1] == "compared" and "breakdown" not in result
    assert set(result["metrics"]) == {"decode_GBps", "study_p95_ms", "setup_s"}
