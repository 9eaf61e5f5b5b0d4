"""``python -m mic_tpu_torch.cli`` against ``python -m mic_tpu.cli``: the
same files in, byte-identical containers and pixels out.  The device
formats (MICW, MWR3) against ``mic_tpu.cli -device``: the port's CLI runs
them with ``-device cpu`` here (the kernels' plain twins), ``mic_tpu``'s
runs its Pallas kernels in interpret mode.  The host formats (MIC1 at
each ``-states`` and ``-grad``, PICS, PICA, MICR, MIC3, ``-dicom`` to MIC1
and MIC2, ``-decode`` of each and of a bare payload, ``-testdata``): both
CLIs in directories of their own, the same files written, the same exit
code and the same standard output.  ``-wavelet`` and ``-gap`` exit 2.
"""

from pathlib import Path

import numpy as np
import pytest
from test_torch_dicom import build_dicom

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
                                  ["-input", "U16", "-width", "128", "-height", "64", "-gap"],
                                  ["-input", "U16", "-width", "9", "-height", "9999", "-micw"],
                                  ["-decode", "JUNK"]])
def test_usage_errors_return_2(argv, rgb_file, u16_file, tmp_path):
    junk = tmp_path / "x.bin"
    junk.write_bytes(b"JUNK" + bytes(20))
    names = {"RGB": str(rgb_file), "U16": str(u16_file), "JUNK": str(junk)}
    assert cli.main([names.get(a, a) for a in argv] + ["-device", "cpu"]) == 2


def test_device_defaults_to_the_card():
    """Without ``-device cpu`` the codec stages go to the GPU: on a machine
    without one the call fails instead of moving to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["-decode", str(TESTDATA / "MR_dev.micw"), "-output", "/dev/null"])


@pytest.fixture()
def mr_file(tmp_path):
    path = tmp_path / "mr.bin"
    path.write_bytes((TESTDATA / "MR_2s.raw").read_bytes())
    return path


def _both(argv, tmp_path, monkeypatch, capsys, port_extra=()):
    """Each CLI from a directory of its own (``port/``, ``ref/``): exit
    codes, the files each wrote (name -> bytes) and standard output."""
    runs = []
    for name, main, extra in (("port", cli.main, port_extra), ("ref", ref_cli.main, ())):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        capsys.readouterr()
        rc = main([*argv, *extra])
        out = capsys.readouterr().out
        files = {p.relative_to(d).as_posix(): p.read_bytes() for p in sorted(d.rglob("*"))
                 if p.is_file()}
        runs.append((rc, files, out))
    return runs


def _same(runs, expect_files=1):
    (rc, files, out), (ref_rc, ref_files, ref_out) = runs
    assert rc == ref_rc == 0
    assert files == ref_files and len(files) >= expect_files
    assert out == ref_out
    return files


def _decode_both(container, tmp_path, monkeypatch, capsys, *flags):
    d = tmp_path / "dec"
    d.mkdir()
    argv = ["-decode", str(container), *flags, "-output", "back.bin"]
    return _same(_both(argv, d, monkeypatch, capsys))["back.bin"]


@pytest.mark.parametrize("flags", [[], ["-states", "1"], ["-states", "4"], ["-states", "8"],
                                   ["-grad"], ["-pics", "4"], ["-pics", "3", "-states", "8"],
                                   ["-pics", "2", "-states", "4"], ["-pica", "3"]])
def test_host_encode_matches_reference(flags, mr_file, tmp_path, monkeypatch, capsys):
    argv = ["-input", str(mr_file), "-width", "256", "-height", "256", "-output", "out.mic",
            *flags]
    blob = _same(_both(argv, tmp_path, monkeypatch, capsys))["out.mic"]
    back = _decode_both(tmp_path / "port" / "out.mic", tmp_path, monkeypatch, capsys)
    assert len(blob) < len(back) == mr_file.stat().st_size
    # A -grad MIC1 records no predictor (pipeline 1, as mic_tpu writes it):
    # -decode reads every MIC1 as avg, in both CLIs, so its pixels differ.
    assert (back == mr_file.read_bytes()) != (flags == ["-grad"])


@pytest.mark.parametrize("wsi", [False, True])
def test_rgb_host_formats_match_reference(wsi, rgb_file, tmp_path, monkeypatch, capsys):
    argv = ["-rgb", str(rgb_file), "-width", "128", "-height", "64", "-output", "out.bin"]
    blob = _same(_both(argv + (["-wsi"] if wsi else []), tmp_path, monkeypatch, capsys))
    assert blob["out.bin"][:4] == (b"MIC3" if wsi else b"MICR")
    back = _decode_both(tmp_path / "port" / "out.bin", tmp_path, monkeypatch, capsys)
    assert back == rgb_file.read_bytes()


def _mr_frames(n):
    mr = np.fromfile(TESTDATA / "MR_2s.raw", "<u2").reshape(256, 256)
    return [np.roll(mr, 3 * k, axis=k % 2).ravel() for k in range(n)]


@pytest.mark.parametrize("n,ts,flags", [(1, "explicit", []), (1, "implicit", ["-states", "8"]),
                                        (3, "explicit", []), (3, "explicit", ["-temporal"]),
                                        (2, "big", ["-temporal", "-states", "4"])])
def test_dicom_matches_reference(n, ts, flags, tmp_path, monkeypatch, capsys):
    frames = _mr_frames(n)
    dcm = tmp_path / "study.dcm"
    dcm.write_bytes(build_dicom(frames, 256, 256, ts=ts))
    argv = ["-dicom", str(dcm), "-output", "study.mic", *flags]
    blob = _same(_both(argv, tmp_path, monkeypatch, capsys))["study.mic"]
    assert blob[:4] == (b"MIC2" if n > 1 else b"MIC1")
    back = _decode_both(tmp_path / "port" / "study.mic", tmp_path, monkeypatch, capsys)
    assert back == np.concatenate(frames).astype("<u2").tobytes()


def test_decode_device_mic2_and_bare_payload_match_reference(mr_file, tmp_path, monkeypatch,
                                                             capsys):
    """A device-format MIC2 fixture (its frames MICW blobs, decoded on
    ``-device cpu`` by the port), and a bare single-frame payload with
    -width/-height."""
    series = TESTDATA / "series_dev_tmp.mic2"
    (rc, files, out), (ref_rc, ref_files, ref_out) = _both(
        ["-decode", str(series), "-output", "s.raw"], tmp_path, monkeypatch, capsys,
        port_extra=("-device", "cpu"))
    assert rc == ref_rc == 0 and files == ref_files and out == ref_out
    assert files["s.raw"] == (TESTDATA / "series_dev_tmp.raw").read_bytes()
    from mic_tpu_torch import compress_single_frame_8state

    px = np.fromfile(mr_file, "<u2")
    bare = tmp_path / "frame.bin"
    bare.write_bytes(compress_single_frame_8state(px, 256, 256, int(px.max())))
    back = _decode_both(bare, tmp_path, monkeypatch, capsys, "-width", "256", "-height", "256")
    assert back == px.tobytes()


def test_testdata_matches_reference(tmp_path, monkeypatch, capsys):
    """-testdata over a corpus of MR and the tissue slide (the port reads it
    from -corpus; mic_tpu's CLI from its fixed corpus path, pointed here)."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "MR_256_256_image.bin").write_bytes((TESTDATA / "MR_2s.raw").read_bytes())
    (corpus / "wsi_tissue_512x384.rgb").write_bytes((TESTDATA / "tissue.raw").read_bytes())
    real_path = ref_cli.Path
    monkeypatch.setattr(ref_cli, "Path", lambda p: corpus if str(p).endswith(
        "reference/testdata") else real_path(p))
    (tmp_path / "runs").mkdir()
    files = _same(_both(["-testdata", "-outdir", "out"], tmp_path / "runs", monkeypatch, capsys,
                        port_extra=("-corpus", str(corpus))), expect_files=4)
    assert sorted(files) == ["out/MR.mic", "out/MR_pics4.pics", "out/tissue.mic3",
                             "out/tissue.micr"]
    assert files["out/tissue.micr"] == (TESTDATA / "tissue.micr").read_bytes()
    assert files["out/tissue.mic3"] == (TESTDATA / "tissue.mic3").read_bytes()
    assert cli.main(["-testdata", "-outdir", str(tmp_path / "x")]) == 2


@pytest.mark.parametrize("flag", ["-wavelet", "-gap"])
def test_unported_pipelines_exit_2(flag, mr_file, tmp_path, capsys):
    out = tmp_path / "out.bin"
    rc = cli.main(["-input", str(mr_file), "-width", "256", "-height", "256", flag,
                   "-output", str(out)])
    assert rc == 2 and not out.exists()
    assert "not ported" in capsys.readouterr().err
