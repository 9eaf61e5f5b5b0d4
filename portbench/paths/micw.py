"""The MICW request path: studies archived as the port's own MICW
containers and decoded by its staged plan (``MicwDecodePlan``).

- ``encode``: each pool slice written by the program's host encoder,
  ``micw_compress``, with the mix's ``lanes``, ``predictor`` and
  ``entropy``, and the slice's own maximum as its maxValue;
- ``stage``: one ``MicwDecodePlan`` a study, each slice its own ``bytes``
  object, as a study read from storage, routed by the mix's ``scan``;
- ``launch``: ``plan.run()``, the bucket launches;
- ``answer``: ``plan.assemble_device(outs)``, the images as int16 tensors
  on the card;
- ``reference_decode``: the plain NumPy decoder of ``reference.py``.
"""

from mic_tpu_torch.tpu.strips import MicwDecodePlan, micw_compress
from portbench.reference import decode_micw as reference_decode  # noqa: F401


def encode(pool, config, traffic):
    w, h = config["width"], config["height"]
    return [micw_compress(px, w, h, int(px.max()), lanes=traffic["lanes"],
                          predictor=traffic["predictor"], entropy=traffic["entropy"])
            for px in pool]


def stage(blobs, device, traffic):
    return MicwDecodePlan([bytes(bytearray(b)) for b in blobs], device, scan=traffic["scan"])


def launch(plan):
    return plan.run()


def answer(plan, outs):
    return plan.assemble_device(outs)
