"""PyTorch/CUDA port of ``iclr_17_compression_tpu`` for NVIDIA H100.

First slice: the Ballé-17 file codec (encode → rANS → decode) at N=128, with
hand-written CUDA kernels for conv+GDN (K2), (I)GDN (K1) and quantize-pack
(K3). Imports torch and numpy only; nothing of JAX or of the JAX package.
Entry points run on the GPU unless given ``device="cpu"``.
"""
