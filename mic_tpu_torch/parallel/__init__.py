"""Container parsers of the reference formats (PICS, MIC2, MIC3) the port
reads (counterpart of ``mic_tpu.parallel``)."""
