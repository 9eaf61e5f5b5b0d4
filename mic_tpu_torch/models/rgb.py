"""Plane modes of the reference's RGB / WSI tile blobs (rgbcompress.go),
as ``mic_tpu.models.rgb`` numbers them (pinned by
``tests/test_torch_isolation.py``)."""

__all__ = ["PLANE_CONSTANT_ZERO", "PLANE_CONSTANT", "PLANE_COMPRESSED", "PLANE_RAW"]

PLANE_CONSTANT_ZERO = 0
PLANE_CONSTANT = 1
PLANE_COMPRESSED = 2
PLANE_RAW = 3
