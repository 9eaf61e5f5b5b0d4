"""File containers the port reads (counterpart of ``mic_tpu.utils``)."""
