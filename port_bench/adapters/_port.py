"""What every adapter reads of the port: its kernels' launch counters and
its storage dtypes."""

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def launch_counts() -> dict:
    """The port's own counts of the forward launches of K1, K2 and K3 so far."""
    from iclr_17_compression_tpu_torch.ops.kernels.conv_gdn_kernel import conv_gdn
    from iclr_17_compression_tpu_torch.ops.kernels.gdn_kernel import gdn_fused
    from iclr_17_compression_tpu_torch.ops.kernels.quant_pack_kernel import quantize_pack

    return {"K1": gdn_fused.launches, "K2": conv_gdn.launches, "K3": quantize_pack.launches}
