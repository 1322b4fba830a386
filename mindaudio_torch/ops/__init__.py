"""Device ops: the kaldi front-end and the int8 GEMM (kernels under ``csrc/``)."""
