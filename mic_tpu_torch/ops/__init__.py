"""Host-side format code the port shares with ``mic_tpu.ops``: numpy
copies of the functions it needs, under the same names, so the port
imports nothing of ``mic_tpu``.  Each copy is pinned to its original by
``tests/test_torch_isolation.py``."""
