"""Host decoders of the reference's single-frame and RGB formats the port
needs (counterpart of ``mic_tpu.models``)."""
