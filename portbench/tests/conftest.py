"""Tests of the benchmark harness (run them with
``python -m pytest portbench/tests``; the ``cuda`` ones need a card).
They import no JAX: the card's machine has none."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

SMALL = {"ct_512_study": [1, 2], "mr_256_exam": [3, 4]}  # study sizes of the CPU runs
# a CPU run's window: a few requests of the slowest cell's plain twins, each
# staged study at least once while other test workers load the CPU
CPU_SECONDS = 12.0


@pytest.fixture
def small_root(tmp_path):
    """A copy of the harness's files whose configurations stage two
    small studies from a pool of three slices, for runs on the CPU."""
    root = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", root, ignore=shutil.ignore_patterns("__pycache__",
                                                                            "tests"))
    for name, sizes in SMALL.items():
        path = root / "configs" / f"{name}.json"
        config = json.loads(path.read_text())
        config.update(study_slices=sizes, staged_studies=len(sizes), pool_slices=3)
        path.write_text(json.dumps(config))
    return root


def cuda_or_skip():
    """The card, decided inside the test that needs it."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda:0")
