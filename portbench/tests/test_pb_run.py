"""The run command measures nothing without a card, and nothing in a
checkout that holds only the benchmark's own files."""

import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

from .conftest import REPO

CELL = harness.load_benchmark()["workloads"][0]["name"]
ARGS = ["--workload", CELL, "--seed", "3000000019", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _run(REPO)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA device" in res.stderr


def test_refuses_with_only_its_own_files(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout == ""
