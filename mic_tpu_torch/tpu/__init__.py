"""Device tier of the port: MICT/MICW host code and the wrappers of the
rANS encode and decode kernels (counterpart of ``mic_tpu.tpu``)."""
