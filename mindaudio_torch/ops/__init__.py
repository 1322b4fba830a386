"""Device ops: the kaldi front-end, SpecAugment, the fused log-mel, the CTC
dynamic program and the int8 GEMM (kernels under ``csrc/``)."""
