"""How the port serves ``balle17_lam2048``: ``models/balle17.py``
``Balle17Compressor`` at N = 128 in the workload's storage dtype
(``ops/precision.py`` ``cast_storage``) and image blocking (``io_block``:
the image fed as ``ops/conv.py`` ``space_to_depth(image, 4)``, the recon
returned blocked), its eval forward (encode, rate, decode) per batch. On
the card the analysis runs as three K2 launches and each IGDN as one K1
launch; the deconvolutions are cuDNN's.
"""

import torch

from ..reference import balle17_lam2048 as reference
from ..work import KernelCall
from ._port import DTYPES


class Codec:
    def __init__(self, workload: dict, config: dict, sd, device):
        from iclr_17_compression_tpu_torch.models.balle17 import Balle17Compressor
        from iclr_17_compression_tpu_torch.ops.precision import cast_storage

        self.io_block, self.dtype = workload["io_block"], DTYPES[workload["storage"]]
        model = Balle17Compressor(config["out_channel_n"], io_block=self.io_block)
        model.load_state_dict(sd)
        self.model = cast_storage(model.to(device).eval(), self.dtype)

    def prepare(self, images: torch.Tensor) -> torch.Tensor:
        from iclr_17_compression_tpu_torch.ops.conv import space_to_depth

        return space_to_depth(images, self.io_block).to(self.dtype).contiguous()

    def submit(self, x: torch.Tensor) -> dict:
        with torch.no_grad():
            return self.model(x)

    def canonical(self, out: dict) -> dict:
        """recon (N, H, W, 3) in the image's layout, latent, bpp."""
        from iclr_17_compression_tpu_torch.ops.conv import depth_to_space

        return {"recon": depth_to_space(out["recon"], self.io_block), "latent": out["latent"],
                "bpp": out["bpp"]}


def build(workload: dict, config: dict, sd, device) -> Codec:
    return Codec(workload, config, sd, device)


def kernel_calls(workload: dict) -> list:
    """The K2 and K1 launches of one batch's forward: conv1 (3×3 s1 over 48
    channels when blocked, else 9×9 s4) + GDN, conv2 5×5 s2 + GDN, conv3
    5×5 s2 alone; the IGDNs at ÷8 and ÷4."""
    b, (h, w), n, s = workload["batch"], workload["hw"], reference.N, workload["io_block"]
    dt = workload["storage"]
    if s > 1:
        conv1 = KernelCall("K2", dt, (b, h // s, w // s, 3 * s * s), (3, 3, 3 * s * s, n), 1, 1)
    else:
        conv1 = KernelCall("K2", dt, (b, h, w, 3), (9, 9, 3, n), 4, 4)
    return [conv1,
            KernelCall("K2", dt, (b, h // 4, w // 4, n), (5, 5, n, n), 2, 2),
            KernelCall("K2", dt, (b, h // 8, w // 8, n), (5, 5, n, n), 2, 2, bias=False, gdn=False),
            KernelCall("K1", dt, (b, h // 8, w // 8, n)),
            KernelCall("K1", dt, (b, h // 4, w // 4, n))]


def model_flops(workload: dict) -> float:
    """The model's conv, deconv and (I)GDN FLOPs of one batch: the unblocked
    model's, whatever layout runs."""
    b, (h, w) = workload["batch"], workload["hw"]
    return 2.0 * reference.model_macs((b, h, w, 3))
