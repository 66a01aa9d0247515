"""Functional ops of the port: GDN, quantization, entropy model, convs,
metrics, and the CUDA kernels under ``kernels/``."""
