"""Learned distributed-source-coding (DSC) stereo codec.

Counterpart of ``iclr_17_compression_tpu/models/dsc.py``: ``DSCConfig``, the
stack specs, every preset of ``DSC_PRESETS`` (the port's own copy, as data),
``DSCStereoModel`` and ``DSCDecoder``. Pipeline (reference models/temp.py):

  z1 = g_a(x)          the image to compress, ÷16 latent
  z2 = g_a(y)          the side-information image (the receiver's camera)
  code = clip(round(g_a22(z1) / step) · step, ±clip)   the transmitted code
  ẑ1 = g_s22(code);  fused = g_z1hat_z2(cat(ẑ1, z2));  x̂ = g_s(fused)

A stack is an indexed ``nn.Sequential`` of blocks (``nn/blocks.py``), so
the keys read ``g_a.<i>.…``, as ``import_dsc`` expects. The coarse
quantizer is ``quantize_code``: the K3 kernel on CUDA, its plain version on
the CPU, giving exactly the JAX package's ``clip(round(x/step)·step, ±clip)``
and the coder's symbols in one pass. Every ResidualBlockWithStride and
ResidualBlockUpsample runs its 3×3 conv + (I)GDN as one K2 call.

Training (``train=True``) replaces both quantizers by additive uniform
noise drawn from one explicit generator in a fixed order, the counterpart
of ``jax.random.split(rng, 3)``: the code (± ``coarse_noise``, then the
clamp), then the base branch's ``z1`` and ``z2`` (± ``fine_noise``).

The fusion modules of the fusion presets sit between ``g_z1hat_z2``'s
input and ``g_s``, as in the JAX package: ``fusion_pre="fif"`` runs ``FIF``
(``models/enhance.py``) on z_cat, in its batch-statistics mode when
``train``; ``fusion_post="bot_att"`` concatenates ``bottleneck_attention``
(``models/attention.py``) of the fused latent against z2 and runs
``final_conv`` (att 2N, rb N); ``"patch_att"`` does the same with
``PatchMatchAttention`` (``bot_mhsa``), its output zero-padded back to the
latent size, and ``final_conv`` (att 2N, rb 2N, rb N); ``"pam"`` runs
``PAM`` (``models/passr.py``) with z2 as the right view, always in its
eval mode.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import (AttentionBlock, ResidualBlock, ResidualBlockUpsample,
                         ResidualBlockWithStride, SubpelConv, init_dsc_)
from ..nn.layers import TorchConv
from ..ops import quant
from ..ops.kernels.quant_pack_kernel import quantize_pack
from ..ops.metrics import ms_ssim
from ..utils.device import precision_on_cuda
from .attention import PatchMatchAttention, bottleneck_attention
from .enhance import FIF
from .passr import PAM

# ---------------------------------------------------------------------------
# Stack specs: (kind, features[, arg]).
#   rb      ResidualBlock(out)
#   rbs     ResidualBlockWithStride(out, stride=arg or 2)
#   rbu     ResidualBlockUpsample(out, r=arg or 2)
#   att     AttentionBlock(ch)
#   att7    AttentionBlock_7 (7×7 GELU residual units)
#   conv3   3×3 conv (stride=arg or 1)
#   conv7   7×7 conv (stride=arg or 1)
#   subpel  SubpelConv(out, r=arg)
# ---------------------------------------------------------------------------

Spec = Tuple


def build_stack(specs: Tuple[Spec, ...], cin: int, act: str = "leaky_relu"
                ) -> Tuple[nn.Sequential, int]:
    """The blocks of ``specs`` on ``cin`` input channels: (the indexed
    ``nn.Sequential``, its output channels)."""
    layers = []
    for spec in specs:
        kind, feat = spec[0], spec[1]
        arg = spec[2] if len(spec) > 2 else None
        if kind == "rb":
            layers.append(ResidualBlock(cin, feat, act=act))
        elif kind == "rbs":
            layers.append(ResidualBlockWithStride(cin, feat, stride=arg or 2, act=act))
        elif kind == "rbu":
            layers.append(ResidualBlockUpsample(cin, feat, upsample=arg or 2, act=act))
        elif kind in ("att", "att7"):
            if cin != feat:
                raise ValueError(f"{kind} {feat} on {cin} input channels")
            layers.append(AttentionBlock(feat) if kind == "att" else
                          AttentionBlock(feat, unit_act="gelu", unit_kernel=7))
        elif kind == "conv3":
            layers.append(TorchConv(cin, feat, 3, stride=arg or 1, padding=1))
        elif kind == "conv7":
            layers.append(TorchConv(cin, feat, 7, stride=arg or 1, padding=3))
        elif kind == "subpel":
            layers.append(SubpelConv(cin, feat, arg or 2))
        else:
            raise ValueError(f"unknown spec kind {kind!r}")
        cin = feat
    return nn.Sequential(*layers), cin


def _ga_specs(n: int, extra_stride: bool = False) -> Tuple[Spec, ...]:
    """Cheng-2020 analysis stack (reference models/temp.py:135-147;
    extra_stride=True is the ÷32 variant, temp_smaller_spatial_dim.py:53-64)."""
    if extra_stride:
        return (
            ("rb", 3), ("rbs", n, 2), ("rb", n), ("rbs", n, 2), ("att", n),
            ("rbs", n, 2), ("rb", n), ("rbs", n, 2), ("rb", n),
            ("conv3", n, 2), ("att", n),
        )
    return (
        ("rb", 3), ("rbs", n, 2), ("rb", n), ("rbs", n, 2), ("att", n),
        ("rb", n), ("rbs", n, 2), ("rb", n), ("conv3", n, 2), ("att", n),
    )


def _gs_specs(n: int, extra_up: bool = False) -> Tuple[Spec, ...]:
    """Cheng-2020 synthesis stack (reference models/temp.py:149-162)."""
    if extra_up:
        return (
            ("att", n), ("rb", n), ("rbu", n, 2), ("rb", n), ("rbu", n, 2),
            ("att", n), ("rbu", n, 2), ("rb", n), ("rbu", n, 2), ("rb", n),
            ("subpel", 3, 2),
        )
    return (
        ("att", n), ("rb", n), ("rbu", n, 2), ("rb", n), ("rbu", n, 2),
        ("att", n), ("rb", n), ("rbu", n, 2), ("rb", n), ("subpel", 3, 2),
    )


def _gz_specs(n: int, cat_factor: int = 2) -> Tuple[Spec, ...]:
    """Fusion net g_z1hat_z2 (reference models/temp.py:195-202; 3N input for
    the addZyDown variant, temp_allRes.py:184-190)."""
    c = cat_factor * n
    return (("att", c), ("rb", c), ("rb", n), ("att", n), ("rb", n))


GREC_SPECS = (("att", 6), ("rb", 3), ("rb", 3), ("att", 3), ("rb", 3))


def final_conv_specs(cfg: "DSCConfig") -> Tuple[Spec, ...]:
    """The stack after the bottleneck attention (``bot_att``) or the
    patch-match attention (``patch_att``), on cat(fused, attention)."""
    if cfg.fusion_post == "patch_att":
        return (("att", 2 * cfg.n), ("rb", 2 * cfg.n), ("rb", cfg.n))
    return (("att", 2 * cfg.n), ("rb", cfg.n))


@dataclass(frozen=True)
class DSCConfig:
    """Full specification of one DSC variant (fields as in the JAX package)."""

    name: str
    n: int = 128                       # base channels
    code_channels: int = 8             # channels of the transmitted code
    ga: Tuple[Spec, ...] = ()
    gs: Tuple[Spec, ...] = ()
    ga22: Tuple[Spec, ...] = ()
    gs22: Tuple[Spec, ...] = ()
    gz: Tuple[Spec, ...] = ()
    shared_encoder: bool = True        # False → a separate SI encoder (g_a_Y)
    base_branch: bool = True           # aux autoencoder branch on z1/z2
    fine_noise: float = 8.0            # train noise half-width for z1/z2
    coarse_noise: float = 8.0          # train noise half-width for the code
    coarse_step: float = 16.0          # eval quant step for the code
    code_clip: Optional[float] = 128.0  # clamp after quantization (None = off)
    fusion: str = "cat2"               # 'cat2' | 'cat3' (addZyDown)
    gz2: Tuple[Spec, ...] = ()         # second fusion branch, summed with gz
    fusion_pre: str = "none"           # 'none' | 'fif'
    fusion_post: str = "none"          # 'none' | 'bot_att' | 'patch_att' | 'pam'
    si_mode: str = "use"               # 'use' | 'zero_si' | 'zero_code'
    loss: str = "msssim"               # 'l1' | 'msssim' | 'mse'
    msssim_win: int = 7
    z_target_coarse: bool = True       # L1 z-loss target round(z1/16)*16 vs z1
    recon_residual: bool = False       # refine x̂ with g_rec1_im2_new(cat(x̂, y))
    latent_div: int = 16               # spatial ÷ of z1/z2
    code_div: int = 32                 # spatial ÷ of the code


# Symbols of an unclipped code (code_clip None): K3's 16-bit store at this
# limit, which no code may reach (it could have been clipped there).
UNCLIPPED_LIM = 32767


def code_symbols(cfg: DSCConfig) -> Tuple[int, int]:
    """(lim, bits) of the coder's symbols of ``cfg``'s code: K3 stores
    ``sym + lim`` for sym in [-lim, lim] in 8 bits where 2·lim+1 ≤ 256
    (step 16, clip 128: 17 symbols), else in 16."""
    if cfg.code_clip is None:
        return UNCLIPPED_LIM, 16
    lim = int(round(cfg.code_clip / cfg.coarse_step))
    if lim * cfg.coarse_step != cfg.code_clip:
        raise ValueError(f"{cfg.name}: clip {cfg.code_clip} is not a multiple of the step "
                         f"{cfg.coarse_step}")
    return lim, 8 if 2 * lim + 1 <= 256 else 16


def quantize_code(code_pre: torch.Tensor, cfg: DSCConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The coarse quantizer: (symbols ``sym + lim`` as uint8 or uint16, the
    code ``sym · step``) with sym = clip(round(code_pre / step), ±lim), in
    one K3 pass on CUDA (the plain version on the CPU). The code equals the
    JAX package's ``clip(round(x/step)·step, ±clip)``; round has no
    gradient there, so none flows here either. An unclipped code that
    reaches ±``UNCLIPPED_LIM`` raises."""
    lim, bits = code_symbols(cfg)
    step = float(cfg.coarse_step)
    with torch.no_grad():
        symbols, code = quantize_pack(code_pre.detach().contiguous(), step, lim * step, bits)
    if cfg.code_clip is None:
        s = symbols.to(torch.int32)  # CUDA has no min/max of uint16
        if int(s.min()) == 0 or int(s.max()) == 2 * lim:
            raise ValueError(f"{cfg.name}: the unclipped code reaches ±{lim} steps")
    return symbols, code


def refuse_untrainable(cfg: DSCConfig) -> None:
    """Raise for a preset that the JAX trainer cannot train: FIF's
    ``AdaptiveBatchNorm`` needs ``batch_stats``, which the JAX trainer
    does not keep (ROADMAP Queue 3)."""
    if cfg.fusion_pre == "fif":
        raise NotImplementedError(
            f"{cfg.name}: the JAX trainer keeps only the params, not FIF's batch_stats, "
            "and cannot train this preset; the port follows it (ROADMAP Queue 3)")


# The modules each fusion option adds, by their names in the model.
FUSION_MODULES = {"none": [], "fif": ["fif"], "bot_att": ["final_conv"],
                  "patch_att": ["bot_mhsa", "final_conv"], "pam": ["pam"]}


def _z_cat(cfg: DSCConfig, z1_hat, z2, z2_hat):
    """The fusion net's input: cat(ẑ1, z2) (or the SI ablations' zeros in
    one of them), or cat(ẑ1, ẑ2, z2) for ``cat3``."""
    if cfg.fusion == "cat3":
        return torch.cat([z1_hat, z2_hat, z2], dim=-1)
    si = torch.zeros_like(z2) if cfg.si_mode == "zero_si" else z2
    zc = torch.zeros_like(z1_hat) if cfg.si_mode == "zero_code" else z1_hat
    return torch.cat([zc, si], dim=-1)


class OneDevice:
    """How the DSC forward runs on one device: ``stack(name, *xs)`` calls
    the module ``name`` of ``mods``, ``module(name)`` is that module,
    ``whole(fn, *xs)`` and ``each(fn, *xs)`` call ``fn`` once.
    ``parallel.tiled.TileRun`` runs the same forward tile by tile."""

    def __init__(self, mods: nn.Module):
        self.mods = mods

    def module(self, name: str) -> nn.Module:
        return getattr(self.mods, name)

    def stack(self, name: str, *xs, **kw):
        return self.module(name)(*xs, **kw)

    def whole(self, fn, *xs):
        return fn(*xs)

    def each(self, fn, *xs):
        return fn(*xs)


def _clip01(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def _cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cat([a, b], dim=-1)


def _fuse_and_synthesize(cfg: DSCConfig, run, z1_hat, z2, z2_hat, im2, train: bool = False):
    """SI fusion + synthesis, the receiver's tail shared by the full model
    and ``DSCDecoder``, under ``run`` (``OneDevice`` or a ``TileRun``):
    (fused, recon_raw), the recon unclipped. The fusion modules that see
    the whole latent (FIF, the bottleneck and patch-match attention) run
    through ``run.whole``; ``train`` reaches FIF's batch statistics only."""
    z_cat = run.each(lambda a, b, c: _z_cat(cfg, a, b, c), z1_hat, z2, z2_hat)
    if cfg.fusion_pre == "fif":
        fif = run.module("fif")
        z_cat = run.whole(lambda z: fif(z, train), z_cat)
    fused = run.stack("g_z1hat_z2", z_cat)
    if cfg.gz2:
        fused = run.each(torch.add, fused, run.stack("g_z1hat_z2_freq2", z_cat))
    if cfg.fusion_post == "bot_att":
        att = run.whole(bottleneck_attention, fused, z2)
        fused = run.stack("final_conv", run.each(_cat, fused, att))
    elif cfg.fusion_post == "patch_att":
        mhsa = run.module("bot_mhsa")

        def patch_att(f, z):
            # the 9×9 patch grid may stop short of the latent: pad back with zeros
            att = mhsa(f, z)
            return F.pad(att, (0, 0, 0, f.shape[2] - att.shape[2], 0, f.shape[1] - att.shape[1]))

        fused = run.stack("final_conv", run.each(_cat, fused, run.whole(patch_att, fused, z2)))
    elif cfg.fusion_post == "pam":
        fused = run.stack("pam", fused, z2, train=False)
    recon = run.stack("g_s", fused)
    if cfg.recon_residual:
        recon = run.each(torch.add, recon, run.stack(
            "g_rec1_im2_new", run.each(_cat, recon, im2)))
    return fused, recon


def si_encoder_name(cfg: DSCConfig) -> str:
    """The stack that encodes the side-information image: ``g_a``, or
    ``g_a_Y`` where the preset has a separate one."""
    return "g_a" if cfg.shared_encoder else "g_a_Y"


def receive(cfg: DSCConfig, run, code, im2):
    """The receiver under ``run``: the unclipped recon of the code with the
    side-information image ``im2``."""
    z2 = run.stack(si_encoder_name(cfg), im2)
    z1_hat = run.stack("g_s22", code)
    z2_hat = run.stack("g_s22", run.stack("g_a22", z2)) if cfg.fusion == "cat3" else None
    return _fuse_and_synthesize(cfg, run, z1_hat, z2, z2_hat, im2)[1]


def dsc_outputs(cfg: DSCConfig, run, im1, im2, train: bool = False, mask_channels=None,
                generator=None) -> Dict[str, object]:
    """``DSCStereoModel``'s forward under ``run`` but its loss triplet: each
    value a tensor (``OneDevice``) or a list of tiles (a ``TileRun``).
    ``generator``: a generator, or an ``ops.quant.SlotNoise`` (a list of
    one a tile under a ``TileRun``); the noise is drawn in the order of the
    module docstring."""

    def noised(x, g, half_width):
        return quant.add_uniform_noise(x, g, half_width)

    z1 = run.stack("g_a", im1)
    z2 = run.stack(si_encoder_name(cfg), im2)
    out = {"z1": z1, "z2": z2}
    code_pre = run.stack("g_a22", z1)
    if mask_channels is not None:
        code_pre = run.each(lambda c: c * (1.0 - mask_channels.to(c.dtype)), code_pre)
    if train:
        code = run.each(lambda c, g: noised(c, g, cfg.coarse_noise), code_pre, generator)
        if cfg.code_clip is not None:
            code = run.each(lambda c: torch.clamp(c, -cfg.code_clip, cfg.code_clip), code)
    else:
        code = run.each(lambda c: quantize_code(c, cfg)[1], code_pre)
    out["code"] = code
    z1_hat = run.stack("g_s22", code)
    out["z1_hat"] = z1_hat
    z2_hat = run.stack("g_s22", run.stack("g_a22", z2)) if cfg.fusion == "cat3" else None
    fused, recon = _fuse_and_synthesize(cfg, run, z1_hat, z2, z2_hat, im2, train)
    out["fused"] = fused
    out["recon_raw"] = recon
    out["recon"] = run.each(_clip01, recon)

    if cfg.base_branch:
        if train:
            cz1 = run.each(lambda z, g: noised(z, g, cfg.fine_noise), z1, generator)
            cz2 = run.each(lambda z, g: noised(z, g, cfg.fine_noise), z2, generator)
        else:
            cz1, cz2 = run.each(torch.round, z1), run.each(torch.round, z2)
        out["im1_hat"] = run.each(_clip01, run.stack("g_s", cz1))
        out["im2_hat"] = run.each(_clip01, run.stack("g_s", cz2))
    return out


def _receiver_stacks(cfg: DSCConfig) -> Tuple[str, ...]:
    """The names of the stacks the receiver runs."""
    names = [si_encoder_name(cfg), "g_s22", "g_z1hat_z2", "g_s"]
    if cfg.fusion == "cat3":
        names.append("g_a22")
    if cfg.gz2:
        names.append("g_z1hat_z2_freq2")
    if cfg.recon_residual:
        names.append("g_rec1_im2_new")
    names += FUSION_MODULES[cfg.fusion_pre] + FUSION_MODULES[cfg.fusion_post]
    return tuple(names)


class DSCStereoModel(nn.Module):
    """Two-branch DSC codec; behaviour set by ``config``.

    ``forward(im1, im2, train=False, mask_channels=None, generator=None)``
    (NHWC in [0, 1]) returns the JAX model's dict:
      recon      SI-assisted reconstruction of im1, clipped to [0, 1]
      recon_raw  the same, unclipped
      code       the quantized and clamped transmitted code
      z1, z2     encoder latents;  z1_hat = g_s22(code);  fused
      im1_hat, im2_hat  aux-branch recons (if ``base_branch``)
      loss, loss_full, loss_z  the reference's loss triplet
    ``mask_channels``: optional (code_channels,) mask zeroing code channels
    before quantization. ``train``: the noise quantizers, drawn from
    ``generator`` (the default generator if None).
    """

    def __init__(self, config: DSCConfig):
        super().__init__()
        if config.fusion_pre not in ("none", "fif") or config.fusion_post not in FUSION_MODULES:
            raise ValueError(f"{config.name}: unknown fusion_pre={config.fusion_pre!r} / "
                             f"fusion_post={config.fusion_post!r}")
        self.config = config
        self.g_a = build_stack(config.ga, 3)[0]
        if not config.shared_encoder:
            self.g_a_Y = build_stack(config.ga, 3)[0]
        self.g_a22 = build_stack(config.ga22, config.n)[0]
        self.g_s22 = build_stack(config.gs22, config.code_channels)[0]
        cat = 3 if config.fusion == "cat3" else 2
        self.g_z1hat_z2, fused_ch = build_stack(config.gz, cat * config.n)
        self.g_s = build_stack(config.gs, fused_ch)[0]
        if config.gz2:
            self.g_z1hat_z2_freq2 = build_stack(config.gz2, cat * config.n)[0]
        if config.recon_residual:
            self.g_rec1_im2_new = build_stack(GREC_SPECS, 6)[0]
        if config.fusion_pre == "fif":
            self.fif = FIF(2 * config.n)
        if config.fusion_post == "patch_att":
            self.bot_mhsa = PatchMatchAttention(config.n)
        if config.fusion_post in ("bot_att", "patch_att"):
            self.final_conv = build_stack(final_conv_specs(config), 2 * config.n)[0]
        elif config.fusion_post == "pam":
            self.pam = PAM(config.n)

    def init_(self, generator: torch.Generator) -> "DSCStereoModel":
        """The JAX package's DSC init (``nn.blocks.init_dsc_``)."""
        return init_dsc_(self, generator)

    def encode(self, im1: torch.Tensor) -> torch.Tensor:
        """The transmitter: ``g_a22(g_a(im1))``, the code before quantization."""
        precision_on_cuda(im1)
        return self.g_a22(self.g_a(im1))

    def outputs(self, im1: torch.Tensor, im2: torch.Tensor, train: bool = False,
                mask_channels: Optional[torch.Tensor] = None,
                generator=None) -> Dict[str, torch.Tensor]:
        """The forward's dict but its loss triplet (``dsc_outputs``)."""
        precision_on_cuda(im1)
        return dsc_outputs(self.config, OneDevice(self), im1, im2, train, mask_channels,
                           generator)

    def forward(self, im1: torch.Tensor, im2: torch.Tensor, train: bool = False,
                mask_channels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        cfg = self.config
        out = self.outputs(im1, im2, train, mask_channels, generator)
        terms = loss_terms(cfg, out, im1, im2)
        out["loss"], out["loss_full"], out["loss_z"] = loss_triplet(
            cfg, lambda name: measure(cfg, *terms[name]), torch.zeros((), device=im1.device))
        return out


def loss_terms(cfg: DSCConfig, out: Dict[str, torch.Tensor], im1: torch.Tensor,
               im2: torch.Tensor) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The (prediction, target) pairs the loss triplet measures, by name:
    ``full`` (the clipped recon and im1), and for the L1 and MSE losses
    ``z`` (the fused latent and z1, or its coarse rounding for
    ``z_target_coarse`` L1), with a base branch also ``base1`` (L1 / MSE)
    and ``base2`` (the aux recons against their images)."""
    terms = {"full": (out["recon"], im1)}
    if cfg.loss != "msssim":
        z1 = out["z1"]
        z_target = (torch.round(z1 / cfg.coarse_step) * cfg.coarse_step
                    if cfg.loss == "l1" and cfg.z_target_coarse else z1)
        terms["z"] = (out["fused"], z_target)
        if cfg.base_branch:
            terms["base1"] = (out["im1_hat"], im1)
    if cfg.base_branch:
        terms["base2"] = (out["im2_hat"], im2)
    return terms


def elementwise_error(cfg: DSCConfig, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a − b| for the L1 loss, (a − b)² for the MSE loss."""
    return torch.abs(a - b) if cfg.loss == "l1" else (a - b) ** 2


def measure(cfg: DSCConfig, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One term's value: MS-SSIM (window ``msssim_win``), else the mean of
    ``elementwise_error``."""
    if cfg.loss == "msssim":
        return ms_ssim(a, b, win_size=cfg.msssim_win)
    return torch.mean(elementwise_error(cfg, a, b))


def loss_triplet(cfg: DSCConfig, value, zero: torch.Tensor):
    """(loss, loss_full, loss_z), the reference's loss triplet, from
    ``value(name)``, each ``loss_terms`` term's value (``measure``, or the
    whole batch's from a split step's sums)."""
    if cfg.loss == "msssim":
        ms_full = value("full")
        loss_full = 1.0 - ms_full
        loss_base = 1.0 - 0.5 * (ms_full + value("base2")) if cfg.base_branch else loss_full
        # reference parity: the MS-SSIM branch hardcodes mse_on_z = 1
        return loss_base, loss_full, zero + 1.0
    loss_z = value("z")
    loss_full = value("full")
    loss_base = (0.5 * value("base1") + 0.5 * value("base2")) if cfg.base_branch else zero
    return loss_base, loss_full, loss_z


class DSCDecoder(nn.Module):
    """The receiver: (code, side-information image) → reconstruction.

    It runs the stacks of ``model`` (a ``DSCStereoModel`` of the same
    preset; a new one when None) under their own names (``g_a`` or ``g_a_Y``
    for the SI encoder, ``g_s22``, ``g_z1hat_z2``, ``g_s``; ``g_a22`` for
    cat3), shared, not copied. ``clip=False`` returns the raw synthesis
    output: the residual that the rate-regression stage adds onto a frozen
    base reconstruction.
    """

    def __init__(self, config: DSCConfig, clip: bool = True,
                 model: Optional[DSCStereoModel] = None):
        super().__init__()
        self.config = config
        self.clip = clip
        model = DSCStereoModel(config) if model is None else model
        for name in _receiver_stacks(config):
            setattr(self, name, getattr(model, name))

    def forward(self, code: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        precision_on_cuda(im2)
        recon = receive(self.config, OneDevice(self), code, im2)
        return _clip01(recon) if self.clip else recon


# ---------------------------------------------------------------------------
# Presets, one per reference variant file (the JAX package's table).
# ---------------------------------------------------------------------------

def _preset(name: str, **kw) -> DSCConfig:
    n = kw.pop("n", 128)
    cc = kw.pop("code_channels", 8)
    defaults = dict(ga=_ga_specs(n), gs=_gs_specs(n), gz=_gz_specs(n))
    defaults.update(kw)
    return DSCConfig(name=name, n=n, code_channels=cc, **defaults)


_GA22_TEMP = (
    ("conv3", 64, 1), ("rb", 64), ("rbs", 64, 2), ("att", 64),
    ("conv3", 32, 1), ("rb", 32), ("conv3", 8, 1), ("att", 8),
)
_GS22_TEMP = (
    ("att", 8), ("conv3", 32, 1), ("rb", 32), ("conv3", 64, 1),
    ("rb", 64), ("rbu", 128, 2), ("rb", 128),
)


def _ga22_wide(c: int) -> Tuple[Spec, ...]:
    return (
        ("conv3", 64, 1), ("rb", 64), ("rbs", 64, 2), ("att", 64),
        ("rb", c), ("rb", c), ("att", c),
    )


def _gs22_wide(c: int, n: int) -> Tuple[Spec, ...]:
    return (("att", c), ("rb", c), ("rb", 64), ("rb", 64), ("rbu", n, 2), ("rb", n))


_TINY22 = dict(
    ga22=(("conv3", 8, 1), ("rbs", 8, 2), ("conv3", 2, 1)),
    gs22=(("conv3", 8, 1), ("rbu", 16, 2), ("rb", 16)),
)

DSC_PRESETS = {
    # models/temp.py — the flagship 0.031 bpp model
    "temp_0031bpp": _preset(
        "temp_0031bpp", ga22=_GA22_TEMP, gs22=_GS22_TEMP,
        fine_noise=8.0, coarse_noise=8.0, coarse_step=16.0, loss="msssim"),
    # models/temp_1bpp.py — 0.125 bpp variant (32-ch code)
    "temp_1bpp": _preset(
        "temp_1bpp", code_channels=32, ga22=_ga22_wide(32), gs22=_gs22_wide(32, 128),
        fine_noise=8.0, coarse_noise=8.0, coarse_step=16.0, loss="l1"),
    # models/temp_016bpp.py — 41-ch code + channel-mask ablation hook
    "temp_016bpp": _preset(
        "temp_016bpp", code_channels=41, ga22=_ga22_wide(41), gs22=_gs22_wide(41, 128),
        fine_noise=8.0, coarse_noise=8.0, coarse_step=16.0, loss="l1"),
    # models/temp_016bpp.py at reference HEAD: zeros concatenated for z2
    "temp_016bpp_si_ablation": _preset(
        "temp_016bpp_si_ablation", code_channels=41, ga22=_ga22_wide(41),
        gs22=_gs22_wide(41, 128), fine_noise=8.0, coarse_noise=8.0, coarse_step=16.0,
        si_mode="zero_si", loss="l1"),
    # models/high_bit_rate_model.py — 32-ch code, fine quant (step 1)
    "high_bit_rate": _preset(
        "high_bit_rate", code_channels=32,
        ga22=(("att", 128), ("rbs", 128, 2), ("rb", 64), ("att", 64), ("rb", 32), ("att", 32)),
        gs22=(("att", 32), ("rb", 64), ("att", 64), ("rb", 128), ("rbu", 128, 2),
              ("att", 128)),
        fine_noise=0.5, coarse_noise=0.5, coarse_step=1.0, loss="l1", z_target_coarse=False),
    # models/classic_DSC_model.py — separate X/Y encoders, all-residual 22-nets
    "classic_dsc": _preset(
        "classic_dsc",
        ga22=(("rb", 64), ("rb", 64), ("rbs", 64, 2), ("att", 64), ("rb", 32), ("rb", 32),
              ("rb", 8), ("att", 8)),
        gs22=(("att", 8), ("rb", 32), ("rb", 32), ("rb", 64), ("rb", 64), ("rbu", 128, 2),
              ("rb", 128)),
        shared_encoder=False, base_branch=False, fine_noise=0.5, coarse_noise=0.5,
        coarse_step=1.0, code_clip=None, loss="l1", z_target_coarse=False),
    # models/model_temp_DSC.py — separate SI encoder, no base branch
    "temp_dsc": _preset(
        "temp_dsc", ga22=_GA22_TEMP, gs22=_GS22_TEMP, shared_encoder=False,
        base_branch=False, fine_noise=0.5, coarse_noise=0.5, coarse_step=1.0, loss="l1",
        z_target_coarse=False),
    # models/temp_allRes.py — decoder-side symmetric degradation (cat3)
    "add_zy_down": _preset(
        "add_zy_down", ga22=_GA22_TEMP, gs22=_GS22_TEMP, gz=_gz_specs(128, 3),
        fusion="cat3", fine_noise=0.5, coarse_noise=0.5, coarse_step=1.0, loss="l1",
        z_target_coarse=False),
    # models/temp_reg_0_0625.py — residual rate-regression stage
    "reg_0_0625": _preset(
        "reg_0_0625", ga22=_GA22_TEMP, gs22=_GS22_TEMP, base_branch=False,
        coarse_noise=8.0, coarse_step=16.0, loss="l1"),
    # models/temp_highBitRate.py — 16-ch code
    "high_bit_rate2": _preset(
        "high_bit_rate2", code_channels=16,
        ga22=(("conv3", 64, 1), ("rb", 64), ("rbs", 64, 2), ("att", 64), ("conv3", 32, 1),
              ("rb", 32), ("conv3", 16, 1), ("att", 16)),
        gs22=(("att", 16), ("conv3", 32, 1), ("rb", 32), ("conv3", 64, 1), ("rb", 64),
              ("rbu", 128, 2), ("rb", 128)),
        fine_noise=8.0, coarse_noise=8.0, coarse_step=16.0, loss="l1"),
    # models/temp_att_0_03bpp.py — + bottleneck cross-attention after fusion
    "att_0031bpp": _preset(
        "att_0031bpp", ga22=_GA22_TEMP, gs22=_GS22_TEMP, fusion_post="bot_att",
        fine_noise=8.0, coarse_noise=8.0, coarse_step=16.0, loss="l1"),
    # models/temp_bottleneck_Att.py — 1bpp net + patch-match attention fusion
    "bottleneck_att_1bpp": _preset(
        "bottleneck_att_1bpp", code_channels=32, ga22=_ga22_wide(32),
        gs22=_gs22_wide(32, 128), fusion_post="patch_att", fine_noise=8.0,
        coarse_noise=8.0, coarse_step=16.0, loss="l1"),
    # models/temp_and_FIF.py — FIF dilated-conv net on z_cat before fusion
    "fif_0031bpp": _preset(
        "fif_0031bpp", ga22=_GA22_TEMP, gs22=_GS22_TEMP, fusion_pre="fif",
        fine_noise=8.0, coarse_noise=8.0, coarse_step=16.0, loss="l1"),
    # models/temp_and_PAM.py — parallax attention after fusion
    "pam_0031bpp": _preset(
        "pam_0031bpp", ga22=_GA22_TEMP, gs22=_GS22_TEMP, fusion_post="pam",
        fine_noise=8.0, coarse_noise=8.0, coarse_step=16.0, loss="l1"),
    # models/modelTemp_largerGz.py — expanded fusion with AttentionBlock_7
    "larger_gz": _preset(
        "larger_gz", ga22=_GA22_TEMP, gs22=_GS22_TEMP,
        gz=(("att7", 256), ("att", 256), ("rb", 256), ("rb", 128), ("att7", 128),
            ("att", 128), ("rb", 128)),
        fine_noise=8.0, coarse_noise=8.0, coarse_step=16.0, loss="l1"),
    # models/test_freqSepNet.py — two parallel fusion nets summed
    "freq_sep": _preset(
        "freq_sep", ga22=_GA22_TEMP, gs22=_GS22_TEMP,
        gz2=(("att7", 256), ("conv7", 256, 1), ("rb", 128), ("att7", 128), ("rb", 128)),
        fine_noise=8.0, coarse_noise=8.0, coarse_step=16.0, loss="l1"),
    # models/original_att.py — architecturally the temp preset, L1 loss
    "original_att": _preset(
        "original_att", ga22=_GA22_TEMP, gs22=_GS22_TEMP,
        fine_noise=8.0, coarse_noise=8.0, coarse_step=16.0, loss="l1"),
    # models/temp_smaller_spatial_dim.py — N=360, ÷32 latent
    "smaller_z": _preset(
        "smaller_z", n=360,
        ga=_ga_specs(360, extra_stride=True), gs=_gs_specs(360, extra_up=True),
        gz=_gz_specs(360),
        ga22=(("conv3", 64, 1), ("rb", 64), ("att", 64), ("rb", 32), ("rb", 32), ("rb", 8),
              ("att", 8)),
        gs22=(("att", 8), ("rb", 32), ("rb", 32), ("rb", 64), ("rb", 64), ("att", 64),
              ("rb", 360), ("rb", 360)),
        fine_noise=0.5, coarse_noise=0.5, coarse_step=1.0, loss="l1",
        z_target_coarse=False, latent_div=32, code_div=32),
    # development preset: the temp_0031bpp topology at 1/8 width
    "tiny": _preset(
        "tiny", n=16, code_channels=2, **_TINY22,
        fine_noise=8.0, coarse_noise=8.0, coarse_step=16.0, loss="mse"),
    # development counterpart of reg_0_0625 (residual stage: no base branch)
    "tiny_reg": _preset(
        "tiny_reg", n=16, code_channels=2, **_TINY22, base_branch=False,
        coarse_noise=8.0, coarse_step=16.0, loss="l1"),
}

