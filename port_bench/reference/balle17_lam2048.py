"""The plain fp32 reference of ``balle17_lam2048`` (Ballé et al., ICLR 2017,
at N = 128), its weights, its control, and the comparison that decides a
codec cell's ``correct``.

  analysis : conv 9×9 s4 p4 → GDN → conv 5×5 s2 p2 → GDN → conv 5×5 s2 p2
  quant    : round half to even
  synthesis: deconv 5×5 s2 p2 op1 → IGDN → deconv 5×5 s2 p2 op1 → IGDN →
             deconv 9×9 s4 p4 op3, clipped to [0, 1]
  rate     : the factorized prior, bits = Σ clip(−log2 ΔC, 0, 50)

NCHW, unblocked, in fp32 with TF32 off; each product's operands go through
``_plain.Cast``, which also counts the products' multiply-accumulates.
Parameters are held under the port's ``state_dict`` keys, which the
benchmark reads from the archived checkpoint itself (``state``) and hands
to both sides.
"""

from pathlib import Path
from typing import Dict

import torch

from .. import flax_msgpack, images
from . import _plain

ROOT = Path(__file__).resolve().parents[2]
N = 128
CHUNK = 16  # images a reference pass takes at once, so that it fits beside the kept outputs


def state(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The archived weights under the port's keys, fp32 on ``device``: conv
    weights OIHW, deconv weights (Cin, Cout, k, k) from the JAX package's
    pre-flipped HWIO, GDN and factorized-prior parameters as stored. The
    seed plays no part: the weights are the archive's."""
    tree = flax_msgpack.read(str(ROOT / config["weights"]["file"]))
    tree = tree.get("params", tree)
    sd = {}
    for side, top in (("encoder", "Encoder"), ("decoder", "Decoder")):
        for name, leaves in tree[side].items():
            for leaf, v in leaves.items():
                t = torch.from_numpy(v.copy())
                if leaf == "weight" and name.startswith("conv"):
                    t = t.permute(3, 2, 0, 1)
                elif leaf == "weight":
                    t = t.permute(2, 3, 0, 1).flip(2, 3)
                sd[f"{top}.{name}.{leaf}"] = t
    for key, v in tree["bit_estimator"].items():
        f, leaf = key.split("_")
        sd[f"bitEstimator.{f}.{leaf}"] = torch.from_numpy(v.copy())
    return {k: v.contiguous().to(device, torch.float32) for k, v in sd.items()}


def make_batch(gen: torch.Generator, batch: int, hw, device) -> torch.Tensor:
    """One batch of the benchmark's input: ``batch`` synthetic images."""
    return images.smooth_images(gen, batch, hw[0], hw[1], device)


class Reference:
    """The plain model on ``sd`` (port keys), computing in ``precision``."""

    def __init__(self, sd: Dict[str, torch.Tensor], precision: str = "fp32"):
        _plain.fp32_flags()
        self.p = sd
        self.cast = _plain.Cast(precision)

    def _gdn(self, x, name, inverse):
        return _plain.gdn(x, self.p[f"{name}.beta"], self.p[f"{name}.gamma"], inverse, self.cast)

    def analysis(self, image: torch.Tensor) -> torch.Tensor:
        """NHWC image in [0, 1] → the NHWC latent before rounding."""
        p, c = self.p, self.cast
        x = _plain.nchw(image)
        x = self._gdn(_plain.conv(x, p["Encoder.conv1.weight"], p["Encoder.conv1.bias"], c, 4, 4),
                      "Encoder.gdn1", False)
        x = self._gdn(_plain.conv(x, p["Encoder.conv2.weight"], p["Encoder.conv2.bias"], c, 2, 2),
                      "Encoder.gdn2", False)
        return _plain.nhwc(_plain.conv(x, p["Encoder.conv3.weight"], None, c, 2, 2))

    def synthesis(self, latent: torch.Tensor) -> torch.Tensor:
        """NHWC latent → the NHWC reconstruction, unclipped."""
        p, c = self.p, self.cast
        x = _plain.nchw(latent)
        for i in (1, 2):
            x = _plain.deconv(x, p[f"Decoder.deconv{i}.weight"], p[f"Decoder.deconv{i}.bias"], c,
                              2, 2, 1)
            x = self._gdn(x, f"Decoder.igdn{i}", True)
        x = _plain.deconv(x, p["Decoder.deconv3.weight"], p["Decoder.deconv3.bias"], c, 4, 4, 3)
        return _plain.nhwc(x)

    def bits(self, latent: torch.Tensor) -> torch.Tensor:
        """Total bits of an NHWC latent under the factorized prior (fp32)."""
        p = self.p
        layers = [(p[f"bitEstimator.f{i}.h"], p[f"bitEstimator.f{i}.b"],
                   p.get(f"bitEstimator.f{i}.a")) for i in (1, 2, 3, 4)]
        return _plain.total_bits(_plain.nchw(latent), layers)

    def forward(self, image: torch.Tensor) -> dict:
        """The eval forward: {recon (clipped), latent, bpp}."""
        latent = torch.round(self.analysis(image))
        recon = torch.clamp(self.synthesis(latent), 0.0, 1.0)
        n, h, w, _ = image.shape
        return {"recon": recon, "latent": latent, "bpp": self.bits(latent) / (n * h * w)}


def model_macs(shape) -> int:
    """Multiply-accumulates of the conv, deconv and (I)GDN products of one
    eval forward of an (N, H, W, 3) image batch (the unblocked model; the
    rate model is left out), counted on the meta device."""
    sd = {k: v.to("meta") for k, v in _meta_state().items()}
    ref = Reference(sd)
    with torch.no_grad():
        ref.synthesis(torch.round(ref.analysis(torch.empty(shape, device="meta"))))
    return ref.cast.macs


def _meta_state() -> Dict[str, torch.Tensor]:
    """Parameters of the reference's shapes on the meta device."""
    sd = {"Encoder.conv1.weight": (N, 3, 9, 9), "Encoder.conv1.bias": (N,),
          "Encoder.conv2.weight": (N, N, 5, 5), "Encoder.conv2.bias": (N,),
          "Encoder.conv3.weight": (N, N, 5, 5),
          "Decoder.deconv1.weight": (N, N, 5, 5), "Decoder.deconv1.bias": (N,),
          "Decoder.deconv2.weight": (N, N, 5, 5), "Decoder.deconv2.bias": (N,),
          "Decoder.deconv3.weight": (N, 3, 9, 9), "Decoder.deconv3.bias": (3,)}
    for g in ("Encoder.gdn1", "Encoder.gdn2", "Decoder.igdn1", "Decoder.igdn2"):
        sd[f"{g}.beta"], sd[f"{g}.gamma"] = (N,), (N, N)
    return {k: torch.empty(v, device="meta") for k, v in sd.items()}


class Control:
    """The reference put in the program's place, in a lower precision: the
    same entry as a codec adapter (``prepare``, ``submit``, ``canonical``)."""

    def __init__(self, sd, precision: str):
        self.ref = Reference(sd, precision)

    def prepare(self, images):
        return images

    def submit(self, images):
        with torch.no_grad():
            return self.ref.forward(images)

    def canonical(self, out) -> dict:
        return out


def compare(sd, images: torch.Tensor, out: dict) -> Dict[str, float]:
    """The numbers of one kept batch: the worst image's share of latent
    elements that differ from round(the reference's analysis), the worst
    image's RMS gap between the program's recon and the reference's
    synthesis of the program's latent, and the relative gap of the batch's
    bpp to the reference forward's (the rate of its own latent)."""
    ref = Reference(sd)
    flips, rmse, bits = [], [], 0.0
    with torch.no_grad():
        for i in range(0, images.shape[0], CHUNK):
            x = images[i:i + CHUNK].float()
            lat = out["latent"][i:i + CHUNK].float()
            y = torch.round(ref.analysis(x))
            flips.append((lat != y).flatten(1).float().mean(1))
            rec = torch.clamp(ref.synthesis(lat), 0.0, 1.0)
            rmse.append(((out["recon"][i:i + CHUNK].float() - rec) ** 2).flatten(1).mean(1).sqrt())
            bits += float(ref.bits(y))
    n, h, w, _ = images.shape
    bpp_ref = bits / (n * h * w)
    return {"latent_flips": float(torch.cat(flips).max()),
            "recon_rmse": float(torch.cat(rmse).max()),
            "bpp_gap": abs(float(out["bpp"]) - bpp_ref) / bpp_ref}
