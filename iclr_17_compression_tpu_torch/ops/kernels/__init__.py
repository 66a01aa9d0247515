"""Hand-written CUDA kernels for Hopper (sm_90a) with their plain versions.

K1 ``gdn_kernel``, K2 ``conv_gdn_kernel``, K3 ``quant_pack_kernel``: the
counterparts of the three Pallas kernels in
``iclr_17_compression_tpu/ops/pallas/``. Built on first use by ``_build``.
"""
