"""PyTorch/CUDA port of ``iclr_17_compression_tpu`` for NVIDIA H100.

Slices so far: the Ballé-17 file codec (encode → rANS → decode) and Ballé-17
training at N=128, and the flagship DSC stereo codec (serving, its
two-stage file, training and the residual stage's trainer) at n=128, and
the scale-hyperprior and joint-autoregressive file codecs at N=192, with
hand-written CUDA kernels for conv+GDN (K2), (I)GDN (K1) and quantize-pack
(K3); K1 and K2 are autograd Functions. Imports torch
and numpy only (scipy for the Gaussian tables and the joint codec's BLAS); nothing of JAX or of the JAX package. Entry points run on
the GPU unless given ``device="cpu"``.
"""
