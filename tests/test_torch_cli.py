"""``python -m mic_tpu_torch.cli`` against ``python -m mic_tpu.cli -device``:
the same files in, byte-identical containers and pixels out.  The port's
CLI runs with ``-device cpu`` here (the kernels' plain twins); ``mic_tpu``'s
runs its Pallas kernels in interpret mode.
"""

from pathlib import Path

import numpy as np
import pytest

from mic_tpu import cli as ref_cli
from mic_tpu_torch import cli

TESTDATA = Path(__file__).resolve().parent.parent / "web" / "testdata"


@pytest.fixture()
def rgb_file(tmp_path):
    t = np.fromfile(TESTDATA / "tissue_dev.raw", np.uint8).reshape(384, 512, 3)
    path = tmp_path / "tile.rgb"
    np.ascontiguousarray(t[128:192, 192:320]).tofile(path)
    return path


@pytest.fixture()
def u16_file(tmp_path):
    ct = np.fromfile(TESTDATA / "CT_dev.raw", "<u2").reshape(512, 512)
    path = tmp_path / "ct.bin"
    np.ascontiguousarray(ct[200:264, 192:320]).tofile(path)
    return path


def test_mwr3_encode_and_decode(rgb_file, tmp_path):
    got, want, back = tmp_path / "a.mwr3", tmp_path / "b.mwr3", tmp_path / "a.rgb"
    args = ["-rgb", str(rgb_file), "-width", "128", "-height", "64", "-micw"]
    assert cli.main([*args, "-output", str(got), "-device", "cpu"]) == 0
    assert ref_cli.main([*args, "-output", str(want)]) == 0
    assert got.read_bytes() == want.read_bytes()
    assert cli.main(["-decode", str(got), "-output", str(back), "-device", "cpu"]) == 0
    assert back.read_bytes() == rgb_file.read_bytes()


def test_micw_encode_and_decode(u16_file, tmp_path):
    got, want, back = tmp_path / "a.micw", tmp_path / "b.micw", tmp_path / "a.raw"
    args = ["-input", str(u16_file), "-width", "128", "-height", "64", "-micw"]
    assert cli.main([*args, "-output", str(got), "-device", "cpu"]) == 0
    assert ref_cli.main([*args, "-output", str(want), "-device"]) == 0
    assert got.read_bytes() == want.read_bytes()
    assert cli.main(["-decode", str(got), "-output", str(back), "-device", "cpu"]) == 0
    assert back.read_bytes() == u16_file.read_bytes()


def test_default_output_paths(rgb_file):
    assert cli.main(["-rgb", str(rgb_file), "-width", "128", "-height", "64", "-micw",
                     "-device", "cpu"]) == 0
    made = Path(str(rgb_file) + ".mwr3")
    assert cli.main(["-decode", str(made), "-device", "cpu"]) == 0
    assert Path(str(made) + ".raw").read_bytes() == rgb_file.read_bytes()


@pytest.mark.parametrize("argv", [[], ["-input", "x.bin"], ["-rgb", "RGB", "-width", "5",
                                                            "-height", "5", "-micw"],
                                  ["-rgb", "RGB", "-width", "128", "-height", "64"],
                                  ["-input", "U16", "-width", "9", "-height", "9999", "-micw"],
                                  ["-decode", "MIC1"]])
def test_usage_errors_return_2(argv, rgb_file, u16_file, tmp_path):
    mic1 = tmp_path / "x.mic"
    mic1.write_bytes(b"MIC1" + bytes(20))
    names = {"RGB": str(rgb_file), "U16": str(u16_file), "MIC1": str(mic1)}
    assert cli.main([names.get(a, a) for a in argv] + ["-device", "cpu"]) == 2


def test_device_defaults_to_the_card():
    """Without ``-device cpu`` the codec stages go to the GPU: on a machine
    without one the call fails instead of moving to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["-decode", str(TESTDATA / "MR_dev.micw"), "-output", "/dev/null"])
