"""The ``pics`` request path and the cell ``ct_pics8``: the PICS plain
reference against the format, the path's calls against the program's
PICS plan, the cell's readers, and runs with the PICS plan broken
underneath, which come out not correct, on the CPU at a small size and
(``cuda``) at the cell's size on the card.

The cell's configuration, ``ct_512_pics8``, is not among the ones that
``conftest.small_root`` cuts for the CPU, so this module's ``small_root``
cuts it the same way.

The faults of ``test_pb_faults.py`` break ``MicwDecodePlan``, which this
path does not call; here the same three faults break ``PicsDecodePlan``."""

import json
import time

import numpy as np
import pytest
import torch

from portbench import harness, reference_pics, studies

from .conftest import CPU_SECONDS, SMALL, cuda_or_skip

BENCH = harness.load_benchmark()
CELL = "ct_pics8"
CARD = {"hbm_bytes_per_s": 3.35e12}
MS = 1_000_000  # ns
CONFIG = "ct_512_pics8"


@pytest.fixture
def small_root(small_root):
    """conftest's small copy, with the cell's configuration cut as the CT
    one is there: two small studies from a pool of three slices."""
    path = small_root / "configs" / f"{CONFIG}.json"
    config = json.loads(path.read_text())
    sizes = SMALL["ct_512_study"]
    config.update(study_slices=sizes, staged_studies=len(sizes), pool_slices=3)
    path.write_text(json.dumps(config))
    return small_root


def test_the_cell_names_the_pics_path():
    cell = harness.find_cell(BENCH, CELL)
    traffic = harness.load_traffic(cell["traffic"])
    assert (cell["config"], cell["chips"], traffic["path"]) == (CONFIG, 1, "pics")
    assert (traffic["states"], traffic["strips"], traffic["in_flight"]) == (8, 8, 1)
    assert set(traffic["assumed"]) == {"path", "states", "strips", "in_flight"}
    layer = {m["name"]: m for m in harness.cell_metrics(BENCH, CELL, True)}
    assert {"tans_ms", "tans_roofline", "post_ms", "post_roofline"} <= set(layer)
    assert not {"lanes_ms", "lanes_roofline"} & set(layer)


def test_the_configuration_is_the_ct_study_archived_as_pics():
    """The cell's configuration serves the CT configuration's slices and
    studies; only its source, its deployment and its archive differ."""
    ct, pics = harness.load_config("ct_512_study"), harness.load_config(CONFIG)
    differ = {k for k in ct.keys() | pics.keys() if ct.get(k) != pics.get(k)}
    assert differ == {"name", "source", "deployment", "archive"}
    entry = next(c for c in BENCH["configs"] if c["name"] == CONFIG)
    assert entry["source"] == pics["source"] and "CompressParallelStrips8State" in entry["source"]


def test_the_cell_runs_on_the_cpu(small_root, monkeypatch):
    """An untraced run of the cell at the small size is correct and never
    turns the program's tracing on."""
    from mic_tpu_torch import trace

    monkeypatch.setattr(trace, "enable", lambda: pytest.fail("tracing on in an untraced run"))
    config = harness.load_config(CONFIG, small_root)
    assert config["study_slices"] == SMALL["ct_512_study"] and config["pool_slices"] == 3
    result, numbers = harness.run_cell(BENCH, CELL, 2**31 + 11, CPU_SECONDS, False, "cpu",
                                       time.perf_counter(), small_root)
    assert result["correct"] and numbers == {k: 0 for k in numbers}
    assert set(result["metrics"]) == {"decode_GBps", "study_p95_ms", "setup_s"}


def test_control_is_not_correct_cpu(small_root):
    from .test_pb_faults import control_reading

    r = control_reading(CELL, 17, torch.device("cpu"), small_root)
    assert not r["correct"] and r["numbers"]["pixels_wrong"] > 0


@pytest.mark.parametrize("states", [2, 4, 8])
def test_reference_equals_the_format(states):
    """The plain reference decodes the writers' containers of every state
    count to the pixels, as the port's host reader does, on the CT and MR
    slices, eight strips a slice and three (a shorter last one)."""
    from mic_tpu_torch.parallel import strips as ps

    write = {2: ps.compress_parallel_strips, 4: ps.compress_parallel_strips_4state,
             8: ps.compress_parallel_strips_8state}[states]
    for name in ("ct_512_study", "mr_256_exam"):
        config = harness.load_config(name)
        px = studies.source_slice(config).ravel()
        w, h = config["width"], config["height"]
        for n in (8, 3):
            blob = write(px, w, h, int(px.max()), num_strips=n)
            got, gw, gh = reference_pics.decode_pics(blob)
            assert (gw, gh) == (w, h) and np.array_equal(got, px)
            assert np.array_equal(got, ps.decompress_parallel_strips(blob)[0])


def test_reference_rejects_what_is_not_pics():
    config = harness.load_config("ct_512_study")
    px = studies.source_slice(config).ravel()
    from mic_tpu_torch.parallel.strips import compress_parallel_strips_8state

    blob = compress_parallel_strips_8state(px, 512, 512, int(px.max()), num_strips=8)
    for bad in (b"MICW" + blob[4:], blob[:18], blob[:200]):
        with pytest.raises(ValueError):
            reference_pics.decode_pics(bad)


def test_the_pics_path_makes_the_plans_calls(small_root):
    """The path writes the containers the reference's 8-state writer
    writes in 8 strips; a stretch's answers equal, in the harness's order,
    those of one ``PicsDecodePlan`` a study of its own copies, each
    request ``run()`` and then ``assemble_device``."""
    from mic_tpu_torch.parallel.strips import compress_parallel_strips_8state
    from mic_tpu_torch.tpu.ref_decode import PicsDecodePlan

    cell = harness.find_cell(BENCH, CELL)
    config = harness.load_config(cell["config"], small_root)
    traffic = harness.load_traffic(cell["traffic"], small_root)
    seed = 3_000_000_023
    served = harness.Served(config, traffic, seed, torch.device("cpu"), small_root)
    blobs = [compress_parallel_strips_8state(px, 512, 512, int(px.max()), num_strips=8)
             for px in studies.make_pool(config, small_root)]
    assert served.blobs == blobs
    assert all(type(p) is PicsDecodePlan and p.blobs == [blobs[j] for j in s]
               and p.blobs[0] is not blobs[s[0]] for p, s in zip(served.plans, served.studies))
    got = []

    class Every:
        def offer(self, study, images):
            got.append((study, images))

    n = 2 * len(served.plans) + 1
    assert served.serve(requests=n, sample=Every())["requests"] == n
    order = studies.request_order(len(served.plans), seed)
    for study, images in got:
        assert study == next(order)
        plan = PicsDecodePlan([blobs[j] for j in served.studies[study]], "cpu")
        want = plan.assemble_device(plan.run())
        assert [(x, y) for _px, x, y in images] == [(512, 512)] * len(want)
        assert all(torch.equal(a, b) for (a, _x, _y), (b, _u, _v) in zip(images, want))


def _stretch(records, counts):
    return {"program": {"stretch": {"requests": 2, "records": records, "counts": counts,
                                    "spans": []}, "setup_spans": [], "setup_counts": {}},
            "card": CARD,
            "trace": {"requests": 2, "by_name": {n: (e - s) / 1e9 for n, s, e in records}}}


def test_readers_of_the_cell():
    """``tans_ms`` and ``post_ms``: each kernel's device ms a request;
    ``tans_roofline``: ``work_bytes.tans`` at 3.35 TB/s over the tANS
    records' seconds (33.5 MB is 10 us, over 4 ms); nothing without the
    kernel, the work or the program."""
    records = [("void tans_groups_kernel(Args)", 0, 4 * MS),
               ("void (anonymous namespace)::post_groups_kernel<true>(Args)", 4 * MS, 7 * MS)]
    ctx = _stretch(records, {"work_bytes.tans": 33_500_000, "work_bytes.post": 67_000_000})
    read = {n: harness.load_metric(n) for n in ("tans_ms", "post_ms", "tans_roofline",
                                                 "post_roofline")}
    assert read["tans_ms"](ctx) == pytest.approx(2.0)
    assert read["post_ms"](ctx) == pytest.approx(1.5)
    assert read["tans_roofline"](ctx) == pytest.approx(100 * 10e-6 / 4e-3)
    assert read["post_roofline"](ctx) == pytest.approx(100 * 20e-6 / 3e-3)
    lanes = _stretch([("lanes_groups_kernel", 0, MS)], {"work_bytes.lanes": 1})
    for name in read:
        assert read[name](lanes) is None
        assert read[name]({"setup_s": 1.0, "card": CARD}) is None


def _state_unchanged(monkeypatch):
    """Each answer is the one before it: the output never moves on."""
    from mic_tpu_torch.tpu.ref_decode import PicsDecodePlan

    orig = PicsDecodePlan.assemble_device
    prev = []

    def stale(self, decoded):
        out = orig(self, decoded)
        prev.append(out)
        return prev.pop(0) if len(prev) > 1 else out
    monkeypatch.setattr(PicsDecodePlan, "assemble_device", stale)


def _half_left_out(monkeypatch):
    """Half of each study's images are never produced."""
    from mic_tpu_torch.tpu.ref_decode import PicsDecodePlan

    orig = PicsDecodePlan.assemble_device
    monkeypatch.setattr(PicsDecodePlan, "assemble_device",
                        lambda self, decoded: orig(self, decoded)[: len(self.blobs) // 2])


def _pixel_altered(monkeypatch):
    """One pixel of each run's first post bucket altered where the post
    kernel wrote it."""
    from mic_tpu_torch.tpu.ref_decode import PicsDecodePlan

    orig = PicsDecodePlan.run

    def altered(self):
        out = orig(self)
        out[0].view(-1)[:1] ^= 1
        return out
    monkeypatch.setattr(PicsDecodePlan, "run", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out,
          "pixel_altered": _pixel_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct_cpu(small_root, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    result, numbers = harness.run_cell(BENCH, CELL, 2**31 + 101, CPU_SECONDS, False, "cpu",
                                       time.perf_counter(), small_root)
    assert not result["correct"] and numbers["pixels_wrong"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct_on_the_card(monkeypatch, fault):
    device = cuda_or_skip()
    FAULTS[fault](monkeypatch)
    result, numbers = harness.run_cell(BENCH, CELL, 3000000201, 2.0, False, device,
                                       time.perf_counter())
    print(f"fault {fault} {CELL}: {numbers}, attempted {result['attempted']}")
    assert not result["correct"] and numbers["pixels_wrong"] > 0
