"""The comparison that decides ``correct``, and the plain reference."""

import numpy as np
import pytest
import torch

from portbench import check, harness, reference, studies

MR = harness.load_config("mr_256_exam")


@pytest.fixture(scope="module")
def pool_and_blobs():
    pool = studies.make_pool({**MR, "pool_slices": 3})
    traffic = harness.load_traffic("ratio")
    return pool, harness.load_path("micw").encode(pool, MR, traffic)


def answers(pool, study):
    return [(torch.from_numpy(pool[j].view(np.int16).copy()), MR["width"], MR["height"])
            for j in study]


def test_right_answers_compare_clean(pool_and_blobs):
    pool, blobs = pool_and_blobs
    study = [0, 2, 1, 1]
    pool_dev = torch.from_numpy(pool.view(np.int16))
    kept = [(0, answers(pool, study))]
    assert check.compare_requests(kept, [np.array(study)], pool_dev, 256, 256) == (0, 0, 0)
    assert check.blob_pixels_wrong(blobs, pool, 256, 256, reference.decode_micw) == 0


def test_one_flipped_pixel_is_not_correct(pool_and_blobs):
    pool, _blobs = pool_and_blobs
    study = [0, 2, 1]
    got = answers(pool, study)
    got[2][0][12345] ^= 1
    wrong, failed, _ = check.compare_requests([(0, got)], [np.array(study)],
                                              torch.from_numpy(pool.view(np.int16)), 256, 256)
    assert (wrong, failed) == (1, 1)
    assert not check.verdict({"pixels_wrong": wrong, "blob_pixels_wrong": 0,
                              "studies_unchecked": 0})


def test_missing_extra_and_misshapen_images_count(pool_and_blobs):
    pool, _blobs = pool_and_blobs
    pool_dev = torch.from_numpy(pool.view(np.int16))
    study = np.array([0, 1, 2])
    short = answers(pool, study)[:2]
    assert check.request_wrong(short, study, pool_dev, 256, 256) == 65536
    extra = answers(pool, [0, 1, 2, 2])
    assert check.request_wrong(extra, study, pool_dev, 256, 256) == 65536
    bent = answers(pool, study)
    bent[1] = (bent[1][0], 128, 512)
    assert check.request_wrong(bent, study, pool_dev, 256, 256) == 65536
    wide = answers(pool, study)
    wide[0] = (wide[0][0].to(torch.int32), 256, 256)
    assert check.request_wrong(wide, study, pool_dev, 256, 256) == 65536


def test_unchecked_study_is_counted(pool_and_blobs):
    pool, _blobs = pool_and_blobs
    kept = [(1, answers(pool, [2]))]
    assert check.compare_requests(kept, [np.array([0]), np.array([2])],
                                  torch.from_numpy(pool.view(np.int16)), 256, 256) == (0, 0, 1)


def test_a_blob_that_no_longer_decodes_is_not_correct(pool_and_blobs):
    pool, blobs = pool_and_blobs
    cut = blobs[1][:len(blobs[1]) // 2]  # the strip data cut off
    assert check.blob_pixels_wrong([blobs[0], cut], pool[:2], 256, 256,
                                   reference.decode_micw) == 65536
    body = bytearray(blobs[2])
    body[-100] ^= 0x5A  # a damaged word of the last strip's stream
    assert check.blob_pixels_wrong([bytes(body)], pool[2:], 256, 256,
                                   reference.decode_micw) > 0


def test_control_is_not_correct(pool_and_blobs):
    pool, blobs = pool_and_blobs
    studies_ = [np.array([0, 1]), np.array([2, 2, 0])]
    kept = check.control_answers(blobs, studies_, torch.device("cpu"), reference.decode_micw)
    wrong, failed, unchecked = check.compare_requests(kept, studies_,
                                                      torch.from_numpy(pool.view(np.int16)),
                                                      256, 256)
    odd = sum(int(np.count_nonzero(pool[j] & 1)) for s in studies_ for j in s)
    assert wrong == odd > 0 and failed == 2 and unchecked == 0


def test_sample_keeps_the_last_of_each_study_and_a_bounded_reservoir():
    sample = check.Sample(np.random.default_rng(0), 3)
    answers_ = [object() for _ in range(50)]
    for i, a in enumerate(answers_):
        sample.offer(i % 4, a)
    kept = sample.kept()
    assert {id(a) for _s, a in kept} >= {id(a) for a in answers_[-4:]}
    assert len(kept) <= 3 + 4 and len(sample.reservoir) == 3


@pytest.mark.parametrize("predictor,entropy,lanes", [
    ("auto-fast", "alias", 128), ("auto", "best", 128), ("auto-r", "standard", 128),
    ("zz", "alias", 128), ("avg", "standard", 64), ("auto-fast", "standard", 32)])
def test_reference_equals_the_format(predictor, entropy, lanes):
    """The plain reference decodes every mode and both coders to the
    pixels, as the port's host decoder does, on CT and MR slices and on a
    banded (1024-wide) image."""
    from mic_tpu_torch.tpu.strips import micw_compress, micw_decompress_host, micw_parse

    ct = studies.source_slice(harness.load_config("ct_512_study")).ravel()
    mr = studies.source_slice(MR).ravel()
    wide = np.tile(mr.reshape(256, 256), (1, 4)).ravel()
    for px, w, h in ((ct, 512, 512), (mr, 256, 256), (wide, 1024, 256)):
        blob = micw_compress(px, w, h, int(px.max()), lanes=lanes, predictor=predictor,
                             entropy=entropy)
        got, gw, gh = reference.decode_micw(blob)
        assert (gw, gh) == (w, h) and np.array_equal(got, px)
        assert np.array_equal(got, micw_decompress_host(blob)[0])
    assert micw_parse(blob)[6] == lanes


def test_reference_on_r_modes_and_raw_strips():
    from mic_tpu_torch.tpu.strips import micw_compress

    tissue = np.fromfile(harness.REPO / "web" / "testdata" / "tissue_dev.raw", dtype=np.uint8)
    green = tissue.reshape(384, 512, 3)[:, :, 1].astype(np.uint16).ravel()  # an RGB slide's
    blob = micw_compress(green, 512, 384, int(green.max()), predictor="auto-r")
    modes = {st[5] for st in reference.micw_parse(blob)[6]}
    assert modes & {8, 9, 10}
    assert np.array_equal(reference.decode_micw(blob)[0], green)
    noise = np.random.default_rng(3).integers(0, 65536, 256 * 128, dtype=np.uint16)
    flat = np.full(256 * 128, 77, np.uint16)
    img = np.concatenate([noise, flat])
    blob = micw_compress(img, 256, 256, 65535)
    assert {st[5] for st in reference.micw_parse(blob)[6]} == {1, 5}
    assert np.array_equal(reference.decode_micw(blob)[0], img)
