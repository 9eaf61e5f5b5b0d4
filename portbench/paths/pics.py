"""The PICS request path: studies archived in the MIC reference's own
parallel-strip containers (PICS, ``parallelstrips.go``), as a PACS holds
archives written by the reference's CPU writers, and decoded by the
program's staged plan of that format (``PicsDecodePlan``).

- ``encode``: each pool slice written by the program's copy of the
  reference writer of the mix's ``states`` (2, 4 or 8:
  ``compress_parallel_strips``, ``_4state``, ``_8state``), in the mix's
  ``strips`` strips, with the slice's own maximum as its maxValue;
- ``stage``: one ``PicsDecodePlan`` a study, each slice its own ``bytes``
  object, as a study read from storage;
- ``launch``: ``plan.run()``, one launch of the tANS kernel and one of
  the post kernel;
- ``answer``: ``plan.assemble_device(outs)``, the images as int16 tensors
  on the card;
- ``reference_decode``: the plain NumPy decoder of ``reference_pics.py``.
"""

from mic_tpu_torch.parallel.strips import (
    compress_parallel_strips,
    compress_parallel_strips_4state,
    compress_parallel_strips_8state,
)
from mic_tpu_torch.tpu.ref_decode import PicsDecodePlan
from portbench.reference_pics import decode_pics as reference_decode  # noqa: F401

WRITERS = {2: compress_parallel_strips, 4: compress_parallel_strips_4state,
           8: compress_parallel_strips_8state}


def encode(pool, config, traffic):
    w, h = config["width"], config["height"]
    write = WRITERS[traffic["states"]]
    return [write(px, w, h, int(px.max()), num_strips=traffic["strips"]) for px in pool]


def stage(blobs, device, traffic):
    return PicsDecodePlan([bytes(bytearray(b)) for b in blobs], device)


def launch(plan):
    return plan.run()


def answer(plan, outs):
    return plan.assemble_device(outs)
