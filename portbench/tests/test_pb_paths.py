"""Request paths are found by name: a path that exists only as a new file
serves a cell from start to end and is judged by its own reference; an
unknown path fails before set-up; the ``micw`` path makes the calls the
program's MICW plan takes, in the harness's order."""

import json
import time

import pytest
import torch

from portbench import harness, studies

BENCH = harness.load_benchmark()

# A path of raw slices: the container is the slice's width and height and
# its u16 pixels, a study is staged as one int16 tensor, a request's
# launch copies it and its answer is a view a slice.  {answer} and
# {reference} let a test break one side.
RAW_PATH = '''"""Raw slices, a test's request path."""
import struct

import numpy as np


def encode(pool, config, traffic):
    w, h = config["width"], config["height"]
    return [struct.pack("<II", w, h) + px.astype("<u2").tobytes() for px in pool]


def stage(blobs, device, traffic):
    import torch

    w, h = struct.unpack_from("<II", blobs[0])
    px = np.stack([np.frombuffer(b, "<u2", offset=8) for b in blobs])
    return torch.from_numpy(px.view(np.int16).copy()).to(device), w, h


def launch(plan):
    return plan[0].clone()


def answer(plan, outs):
    _px, w, h = plan
    {answer}
    return [(row, w, h) for row in outs]


def reference_decode(blob):
    w, h = struct.unpack_from("<II", blob)
    px = np.frombuffer(blob, "<u2", offset=8).copy()
    {reference}
    return px, w, h
'''
SOUND = {"answer": "pass", "reference": "pass"}


def _raw_cell(root, name: str, **broken) -> dict:
    """A path ``name`` written into ``root`` as a new file, a mix that
    names it and a cell of the CT configuration under that mix; returns
    the benchmark with the cell."""
    (root / "paths" / f"{name}.py").write_text(RAW_PATH.format(**{**SOUND, **broken}))
    mix = {"name": f"mix_{name}", "why": "a test mix", "path": name, "in_flight": 1}
    (root / "traffic" / f"mix_{name}.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": f"ct_{name}", "config": "ct_512_study",
                               "traffic": f"mix_{name}", "chips": 1, "why": "a test cell"})
    return bench


@pytest.mark.parametrize("traced", [False, True])
def test_a_path_that_is_a_new_file_serves_a_cell(small_root, monkeypatch, traced):
    monkeypatch.setattr(harness, "TRACE_REQUESTS", 3)
    bench = _raw_cell(small_root, "raw_test")
    result, numbers = harness.run_cell(bench, "ct_raw_test", 2**33 + 5, 0.5, traced, "cpu",
                                       time.perf_counter(), small_root)
    assert result["correct"] and numbers == {k: 0 for k in numbers}
    assert result["attempted"] > 0 and list(result)[-1] == "compared"
    want = {"decode_GBps", "study_p95_ms", "setup_s"} if not traced else {"plan_stage_s",
                                                                          "dispatch_ms"}
    assert want <= set(result["metrics"])


@pytest.mark.parametrize("broken,number", [
    ({"answer": "outs = outs.clone(); outs[0, 5] ^= 1"}, "pixels_wrong"),
    ({"reference": "px = px ^ 1"}, "blob_pixels_wrong")])
def test_a_new_path_is_judged_by_its_own_reference(small_root, broken, number):
    """One pixel altered in each answer, or a plain decoder that reads the
    containers wrong: the run is not correct, by the number that sees it."""
    bench = _raw_cell(small_root, "raw_broken", **broken)
    result, numbers = harness.run_cell(bench, "ct_raw_broken", 11, 0.5, False, "cpu",
                                       time.perf_counter(), small_root)
    assert not result["correct"] and numbers[number] > 0


def test_an_unknown_path_fails_before_set_up(small_root, monkeypatch):
    mix = {"name": "mix_missing", "why": "a test mix", "path": "no_such_path", "in_flight": 1}
    (small_root / "traffic" / "mix_missing.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "ct_missing", "config": "ct_512_study",
                               "traffic": "mix_missing", "chips": 1, "why": "a test cell"})
    monkeypatch.setattr(studies, "make_pool", lambda *a, **k: pytest.fail("set-up began"))
    with pytest.raises(FileNotFoundError, match=r"paths/no_such_path\.py"):
        harness.run_cell(bench, "ct_missing", 3, 0.5, False, "cpu", time.perf_counter(),
                         small_root)


def test_a_mix_without_a_path_takes_micw():
    for w in BENCH["workloads"]:
        assert "path" not in harness.load_traffic(w["traffic"])
    assert harness.DEFAULT_PATH == "micw"


def test_the_micw_path_makes_the_plans_calls(small_root):
    """The ``micw`` path writes the containers ``micw_compress`` writes with
    the mix's lanes, predictor and entropy; a stretch's answers equal, in
    the harness's order, those of one ``MicwDecodePlan`` a study of its
    own copies of the containers, routed by the mix's ``scan``, each
    request ``run()`` and then ``assemble_device``."""
    from mic_tpu_torch.tpu.strips import MicwDecodePlan, micw_compress

    cell = BENCH["workloads"][0]
    config = harness.load_config(cell["config"], small_root)
    traffic = harness.load_traffic(cell["traffic"], small_root)
    seed = 3_000_000_019
    served = harness.Served(config, traffic, seed, torch.device("cpu"), small_root)
    w, h = config["width"], config["height"]
    blobs = [micw_compress(px, w, h, int(px.max()), lanes=traffic["lanes"],
                           predictor=traffic["predictor"], entropy=traffic["entropy"])
             for px in studies.make_pool(config, small_root)]
    assert served.blobs == blobs
    plans = [MicwDecodePlan([bytes(bytearray(blobs[j])) for j in s], "cpu", scan=traffic["scan"])
             for s in served.studies]
    assert all(type(p) is MicwDecodePlan and p.blobs == q.blobs and p.blobs[0] is not blobs[0]
               for p, q in zip(served.plans, plans))
    got = []

    class Every:
        def offer(self, study, images):
            got.append((study, images))

    n = 2 * len(plans) + 1
    assert served.serve(requests=n, sample=Every())["requests"] == n
    order = studies.request_order(len(plans), seed)
    for study, images in got:
        assert study == next(order)
        want = plans[study].assemble_device(plans[study].run())
        assert [(x, y) for _px, x, y in images] == [(x, y) for _px, x, y in want]
        assert all(torch.equal(a, b) for (a, _x, _y), (b, _u, _v) in zip(images, want))
