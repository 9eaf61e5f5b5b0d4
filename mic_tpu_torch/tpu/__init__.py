"""Device tier of the port: MICT/MICW decode-side host code and the
fused rANS decode kernels' wrappers (counterpart of ``mic_tpu.tpu``)."""
