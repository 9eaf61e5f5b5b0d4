"""The port's reference-format ingest (``mic_tpu_torch.tpu.ingest``)
against ``mic_tpu.tpu.ingest``: the MICW bytes must be equal.

* ``transcode_frame`` / ``transcode_pics`` / ``transcode_auto`` under
  both reference decode tiers (``entropy="native"``, the copied Python
  tier, and ``"device"``, the tANS kernel) and both re-encodes
  (``device_encode`` False: ``auto-fast`` with each target entropy, True:
  zzd standard), byte for byte against ``mic_tpu``'s (whose kernels run
  in interpret mode);
* the grad pipeline (kind 1) on the device tier; kinds 2 and 3 (med, zz)
  on the Python tier, against the pixels and, where ``libmicfse`` is
  built, against ``mic_tpu``'s C++ decode of the same frames;
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
    with pytest.raises(ValueError):
        ingest.transcode_frame(blob, w, h, CPU, kind=4)
    with pytest.raises(ValueError):
        ingest.transcode_frame(blob, w, h, CPU, entropy="gpu")


def _frame_of_kind(ref, px, w, h, kind):
    """A single-frame blob of predictor kind 2 (med) or 3 (zz), written by
    mic_tpu's Python encoder parts: the fused Delta+RLE stream through the
    2-state FSE chain."""
    from mic_tpu.ops import deltarle

    stream = deltarle._fused_compress(px, w, h, int(px.max()), {2: "med", 3: "zz"}[kind])
    return ref.sf._fse_chain(np.asarray(stream, np.uint16), 2)


@pytest.mark.parametrize("kind", [2, 3])
@pytest.mark.parametrize("entropy", ["native", "device"])
def test_med_and_zz_kinds_decode_on_the_python_tier(ref, images, kind, entropy):
    """Kinds 2 and 3 decode through the fused Delta+RLE decode with the
    med / zz predictor under either tier, back to the pixels."""
    from mic_tpu_torch.ops import deltarle as port_deltarle

    px, w, h = images["grad"]
    blob = _frame_of_kind(ref, px, w, h, kind)
    got, gw, gh = ingest._decode_reference(blob, w, h, kind, CPU, entropy=entropy)
    assert (gw, gh) == (w, h) and np.array_equal(got, px)
    other = ingest._decode_reference(blob, w, h, 5 - kind, CPU, entropy=entropy)[0]
    assert not np.array_equal(other, px)  # the kind matters
    micw = ingest.transcode_frame(blob, w, h, CPU, kind=kind, entropy=entropy)
    assert micw == ingest.micw_compress_device(px, w, h, int(px.max()), CPU,
                                               predictor="auto-fast")
    from mic_tpu.ops import deltarle as ref_deltarle
    from mic_tpu.ops.fse_codec import fse_decompress_auto

    syms = fse_decompress_auto(blob)
    if kind == 3:
        assert np.array_equal(port_deltarle.zz_delta_rle_decompress(syms, w, h),
                              ref_deltarle.zz_delta_rle_decompress(syms, w, h))


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_python_tier_equals_native_tier_where_built(images, kind):
    """mic_tpu's C++ tier (libmicfse) writes a frame of each predictor
    kind; the port's Python tier decodes it to the same pixels as
    ``decompress_frame_native``.  Skips where the library is not built
    (``make -C mic_tpu/native``)."""
    pytest.importorskip("jax")
    from mic_tpu import native

    if not native.available():
        pytest.skip("libmicfse is not built")
    px, w, h = images["grad"]
    for n_states in (2, 4):
        blob = native.compress_frame_native(px, w, h, int(px.max()), kind=kind,
                                            n_states=n_states)
        want = native.decompress_frame_native(blob, w, h, kind)
        got, _w, _h = ingest._decode_reference(blob, w, h, kind, CPU)
        assert np.array_equal(got, want) and np.array_equal(got, px)


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
