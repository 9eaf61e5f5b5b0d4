"""Runs with the timed path broken underneath come out not correct, and
so does the control: the plain reference in the program's place with
the lowest bit of each pixel cleared.

On the CPU the cells run at a small size (the program's kernels run
their plain twins there); the ``cuda`` tests run them at the cells' own
sizes on the card, where they print the control's readings."""

import time

import numpy as np
import pytest
import torch

from mic_tpu_torch.tpu.strips import MicwDecodePlan
from portbench import check, harness, studies

from .conftest import CPU_SECONDS, cuda_or_skip

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _state_unchanged(monkeypatch):
    """Each answer is the one before it: the output never moves on."""
    orig = MicwDecodePlan.assemble_device
    prev = []

    def stale(self, decoded):
        out = orig(self, decoded)
        prev.append(out)
        return prev.pop(0) if len(prev) > 1 else out
    monkeypatch.setattr(MicwDecodePlan, "assemble_device", stale)


def _half_left_out(monkeypatch):
    """Half of each study's images are never produced."""
    orig = MicwDecodePlan.assemble_device
    monkeypatch.setattr(MicwDecodePlan, "assemble_device",
                        lambda self, decoded: orig(self, decoded)[: len(self.blobs) // 2])


def _pixel_altered(monkeypatch):
    """One pixel of each run's first bucket altered where the kernel
    wrote it."""
    orig = MicwDecodePlan.run

    def altered(self):
        out = orig(self)
        first = next(iter(out.values()))
        first.view(-1)[:1] ^= 1
        return out
    monkeypatch.setattr(MicwDecodePlan, "run", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out,
          "pixel_altered": _pixel_altered}


def _run(workload, seed, seconds, device, root=harness.ROOT):
    return harness.run_cell(BENCH, workload, seed, seconds, False, device, time.perf_counter(),
                            root)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct_cpu(small_root, monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch)
    result, numbers = _run(workload, 2**31 + 101, CPU_SECONDS, "cpu", small_root)
    assert not result["correct"] and numbers["pixels_wrong"] > 0


def control_reading(workload: str, seed: int, device, root=harness.ROOT) -> dict:
    """The control at the cell's own size: every staged study answered by
    the reference with each pixel's lowest bit cleared, judged as a run's
    answers are."""
    cell = harness.find_cell(BENCH, workload)
    config = harness.load_config(cell["config"], root)
    traffic = harness.load_traffic(cell["traffic"], root)
    path = harness.load_path(traffic.get("path", harness.DEFAULT_PATH), root)
    pool = studies.make_pool(config, root)
    blobs = path.encode(pool, config, traffic)
    staged = studies.make_studies(config, seed)
    kept = check.control_answers(blobs, staged, device, path.reference_decode)
    pool_dev = torch.from_numpy(pool.view(np.int16)).to(device)
    wrong, failed, unchecked = check.compare_requests(kept, staged, pool_dev, config["width"],
                                                      config["height"])
    numbers = {"pixels_wrong": wrong, "blob_pixels_wrong": check.blob_pixels_wrong(
        blobs, pool, config["width"], config["height"], path.reference_decode),
        "studies_unchecked": unchecked}
    return {"numbers": numbers, "correct": check.verdict(numbers), "failed": failed,
            "pixels": sum(len(s) for s in staged) * config["width"] * config["height"]}


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_cpu(small_root, workload):
    r = control_reading(workload, 17, torch.device("cpu"), small_root)
    assert not r["correct"] and r["numbers"]["pixels_wrong"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_on_the_card(workload):
    device = cuda_or_skip()
    for seed in (3000000101, 3000000102, 3000000103):
        r = control_reading(workload, seed, device)
        print(f"control {workload} seed {seed}: {r}")
        assert not r["correct"] and r["numbers"]["pixels_wrong"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct_on_the_card(monkeypatch, workload, fault):
    device = cuda_or_skip()
    FAULTS[fault](monkeypatch)
    result, numbers = _run(workload, 3000000201, 2.0, device)
    print(f"fault {fault} {workload}: {numbers}, attempted {result['attempted']}")
    assert not result["correct"] and numbers["pixels_wrong"] > 0
