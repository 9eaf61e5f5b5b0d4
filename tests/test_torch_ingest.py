"""The port's reference-format ingest (``mic_tpu_torch.tpu.ingest``)
against ``mic_tpu.tpu.ingest``: the MICW bytes must be equal.

* ``transcode_frame`` / ``transcode_pics`` / ``transcode_auto`` under
  both reference decode tiers (``entropy="native"``, the copied Python
  tier, and ``"device"``, the tANS kernel) and both re-encodes
  (``device_encode`` False: ``auto-fast`` with each target entropy, True:
  zzd standard), byte for byte against ``mic_tpu``'s (whose kernels run
  in interpret mode);
* the grad pipeline (kind 1) on the device tier, and the kinds the port
  does not take raising;
* ``ingest_plan``: the staged containers equal ``mic_tpu``'s and decode
  to the source pixels;
* the Python tier's decoders copied from ``mic_tpu`` (single frames and
  PICS) pinned to the originals.

Tolerance 0.  Images are seeded, small (the encode kernel's interpret
mode is the cost).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mic_tpu_torch.models import single_frame
from mic_tpu_torch.parallel import strips
from mic_tpu_torch.tpu import ingest

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref():
    """mic_tpu's reference coders and ingest (needs jax)."""
    pytest.importorskip("jax")
    from mic_tpu.models import single_frame as rsf
    from mic_tpu.parallel import strips as rstrips
    from mic_tpu.tpu import ingest as ringest

    return SimpleNamespace(sf=rsf, strips=rstrips, ingest=ringest)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(31)

    def img(h, w):
        a = (rng.standard_normal((h, w)).cumsum(0).cumsum(1) * 4).astype(np.int64)
        return (a - a.min()).clip(0, 4000).astype(np.uint16).ravel()

    return {"frame": (img(48, 128), 128, 48), "pics": (img(64, 128), 128, 64),
            "grad": (img(40, 96), 96, 40)}


@pytest.mark.parametrize("entropy", ["native", "device"])
@pytest.mark.parametrize("device_encode", [False, True])
def test_transcode_frame_matches(ref, images, entropy, device_encode):
    px, w, h = images["frame"]
    blob = ref.sf.compress_single_frame_4state(px, w, h, int(px.max()))
    got = ingest.transcode_frame(blob, w, h, CPU, entropy=entropy, device_encode=device_encode)
    want = ref.ingest.transcode_frame(blob, w, h, entropy=entropy, device_encode=device_encode)
    assert got == want


@pytest.mark.parametrize("entropy,target", [("native", "alias"), ("device", "best"),
                                            ("device", "standard")])
def test_transcode_pics_and_auto_match(ref, images, entropy, target):
    px, w, h = images["pics"]
    blob = ref.strips.compress_parallel_strips_8state(px, w, h, int(px.max()), num_strips=4)
    got = ingest.transcode_pics(blob, CPU, entropy=entropy, target_entropy=target)
    assert got == ref.ingest.transcode_pics(blob, entropy=entropy, target_entropy=target)
    assert ingest.transcode_auto(blob, 0, 0, CPU, entropy=entropy, target_entropy=target) == got
    with pytest.raises(ValueError):
        ingest.transcode_pics(blob[4:], CPU)


def test_grad_and_unsupported_kinds(ref, images):
    """kind 1 (grad) through the device tier equals mic_tpu's; the Python
    tier honours it too.  mic_tpu's own Python tier decodes every frame
    as avg, so it is held against the pixels, not against that tier."""
    px, w, h = images["grad"]
    blob = ref.sf.compress_single_frame_grad(px, w, h, int(px.max()))
    got = ingest.transcode_frame(blob, w, h, CPU, kind=1, entropy="device")
    assert got == ref.ingest.transcode_frame(blob, w, h, kind=1, entropy="device")
    assert ingest.transcode_auto(blob, w, h, CPU, kind=1, entropy="native") == got
    for kind in (2, 3):
        for entropy in ("native", "device"):
            with pytest.raises(NotImplementedError):
                ingest.transcode_frame(blob, w, h, CPU, kind=kind, entropy=entropy)
    with pytest.raises(ValueError):
        ingest.transcode_frame(blob, w, h, CPU, entropy="gpu")


@pytest.mark.parametrize("device_encode", [False, True])
def test_ingest_plan_matches(ref, images, device_encode):
    fpx, fw, fh = images["frame"]
    ppx, pw, ph = images["pics"]
    blobs = [ref.strips.compress_parallel_strips_4state(ppx, pw, ph, int(ppx.max()),
                                                        num_strips=2),
             ref.sf.compress_single_frame_8state(fpx, fw, fh, int(fpx.max()))]
    dims = [None, (fw, fh)]
    timings = {}
    plan = ingest.ingest_plan(blobs, dims, CPU, entropy="device",
                              device_encode=device_encode, timings=timings)
    want = ref.ingest.ingest_plan(blobs, dims, entropy="device", device_encode=device_encode)
    assert plan.blobs == want.blobs
    assert set(timings) == {"decode_s", "encode_s", "stage_s"}
    outs = plan.assemble(plan.run())
    assert np.array_equal(outs[0][0], ppx) and np.array_equal(outs[1][0], fpx)


def test_python_tier_matches(ref, images):
    px, w, h = images["pics"]
    frame = ref.sf.compress_single_frame(px, w, h, int(px.max()))
    assert np.array_equal(single_frame.decompress_single_frame(frame, w, h), px)
    assert np.array_equal(single_frame.decompress_single_frame(frame, w, h),
                          ref.sf.decompress_single_frame(frame, w, h))
    gpx, gw, gh = images["grad"]
    grad = ref.sf.compress_single_frame_grad(gpx, gw, gh, int(gpx.max()))
    assert np.array_equal(single_frame.decompress_single_frame_grad(grad, gw, gh),
                          ref.sf.decompress_single_frame_grad(grad, gw, gh))
    pics = ref.strips.compress_parallel_strips_4state(px, w, h, int(px.max()), num_strips=3)
    got, want = strips.decompress_parallel_strips(pics), ref.strips.decompress_parallel_strips(pics)
    assert got[1:] == want[1:] == (w, h) and np.array_equal(got[0], want[0])
