"""Synthetic images, made on the device from a seed.

A torch rewrite of ``chip_smoke.py``'s ``smooth_image``, batched: a few
low-frequency colour waves, 64-pixel steps and fine texture, clipped to
[0, 1]. Every random number comes from one ``torch.Generator`` on the
device, in a few large draws, so the same seed gives the same images and
every seed the same sizes.
"""

import math

import torch

SEED_MOD = 1 << 63


def mix(seed: int, stream: int) -> int:
    """A 63-bit generator seed for stream ``stream`` of the run seed ``seed``
    (any whole number, however large)."""
    return (seed * 1_000_003 + stream * 7_919 + 12_345) % SEED_MOD


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, stream))


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def smooth_images(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, h, w, 3) float32 images in [0, 1]."""
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w)
    img = _uniform(gen, (n, 1, 1, 3), 0.3, 0.7, device).expand(n, h, w, 3).clone()
    waves = _uniform(gen, (6, n, 6), 0.0, 1.0, device)
    for k in range(6):
        fy = (12.0 * waves[k, :, 0] - 6.0).view(n, 1, 1) / h
        fx = (12.0 * waves[k, :, 1] - 6.0).view(n, 1, 1) / w
        phase = (2.0 * math.pi * waves[k, :, 2]).view(n, 1, 1)
        amp = (0.03 + 0.09 * waves[k, :, 3:6]).view(n, 1, 1, 3)
        img += amp * torch.cos(2.0 * math.pi * (fy * yy + fx * xx) + phase).unsqueeze(-1)
    blocks = _uniform(gen, (n, -(-h // 64), -(-w // 64), 3), -0.15, 0.15, device)
    img += blocks.repeat_interleave(64, 1).repeat_interleave(64, 2)[:, :h, :w]
    img += 0.03 * torch.randn((n, h, w, 3), generator=gen, device=device)
    return img.clamp_(0.0, 1.0)

