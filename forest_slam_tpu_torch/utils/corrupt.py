"""Image corruptions for robustness runs (port of utils/corrupt.py).

- Motion blur: a unit-sum line kernel at an angle with a tent cross-profile,
  applied to the whole image, and random kernel-size regions (Bernoulli seed
  pixels dilated by a max-pool) that keep the blurred values.
- Sensor nuisance, a photometric domain shift: per-frame exposure gain and
  bias, gamma jitter, shot and read noise, radial vignetting.

The random draws come from a ``torch.Generator``, or are handed in (the
blur's seed mask, the sensor's per-frame values and noise), so a test can
give both packages the same numbers. The blur sums its kernel's taps one
shifted slice at a time, so no TF32 rounding enters on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from forest_slam_tpu_torch.utils.filters import maxpool2d_same


class BlurConfig(NamedTuple):
    blur_percentage: float = 0.0  # % of pixels seeding blurred regions
    kernel_size: int = 15
    angle_deg: float = 0.0


def motion_blur_kernel(kernel_size: int, angle_deg: float) -> torch.Tensor:
    """(k, k) float32 unit-sum line kernel at ``angle_deg`` (0 = horizontal),
    on the CPU."""
    k = kernel_size
    theta = torch.deg2rad(torch.tensor(angle_deg, dtype=torch.float32))
    c = (k - 1) / 2.0
    ar = torch.arange(k, dtype=torch.float32) - c
    ys, xs = torch.meshgrid(ar, ar, indexing="ij")
    along = xs * torch.cos(theta) + ys * torch.sin(theta)
    perp = -xs * torch.sin(theta) + ys * torch.cos(theta)
    w = torch.clamp(1.0 - perp.abs(), 0.0, 1.0) * (along.abs() <= c + 0.5)
    return w / torch.clamp(w.sum(), min=1e-6)


def apply_motion_blur(images: torch.Tensor, kernel_size: int = 15, angle_deg: float = 0.0,
                      kernel: torch.Tensor | None = None) -> torch.Tensor:
    """SAME cross-correlation of (..., H, W) with the line kernel (or the
    (kh, kw) ``kernel`` given), zero padding, in float32."""
    kern = (motion_blur_kernel(kernel_size, angle_deg) if kernel is None else kernel).detach().float().cpu()
    kh, kw = kern.shape
    H, W = images.shape[-2:]
    top, left = (kh - 1) // 2, (kw - 1) // 2
    p = F.pad(images.float(), (left, kw - 1 - left, top, kh - 1 - top))
    out = torch.zeros_like(images, dtype=torch.float32)
    for (dy, dx), w in zip(torch.nonzero(kern).tolist(), kern[kern != 0].tolist()):
        out = out + p[..., dy:dy + H, dx:dx + W] * w
    return out


def apply_random_motion_blur(images: torch.Tensor, cfg: BlurConfig = BlurConfig(),
                             generator: torch.Generator | None = None, seeds: torch.Tensor | None = None,
                             kernel: torch.Tensor | None = None) -> torch.Tensor:
    """Blur random kernel-size regions of (..., H, W) images: each pixel
    seeds a region with probability ``blur_percentage`` / 100 (``seeds``, a
    bool mask of the images' shape, when given). ``blur_percentage`` 0
    returns the images unchanged."""
    if cfg.blur_percentage <= 0.0:
        return images
    blurred = apply_motion_blur(images, cfg.kernel_size, cfg.angle_deg, kernel)
    if seeds is None:
        u = torch.rand(images.shape, generator=generator, device=images.device)
        seeds = u < cfg.blur_percentage / 100.0
    mask = maxpool2d_same(seeds.float(), cfg.kernel_size)
    return torch.where(mask > 0, blurred, images.float())


def corrupt_stack(images: torch.Tensor, generator: torch.Generator | None = None, cfg: BlurConfig = BlurConfig(),
                  seeds: torch.Tensor | None = None, kernel: torch.Tensor | None = None) -> torch.Tensor:
    """Random motion blur over an (N, H, W) stack, each frame its own
    regions."""
    return apply_random_motion_blur(images, cfg, generator, seeds, kernel)


class SensorConfig(NamedTuple):
    max_gain: float = 0.25  # log-uniform exposure gain
    max_bias: float = 12.0  # gray levels
    max_gamma: float = 0.25
    shot_sigma: float = 5.0  # gray levels at full scale
    read_sigma: float = 2.0  # gray levels
    vignette: float = 0.35  # corner attenuation fraction


class SensorDraws(NamedTuple):
    """Per-frame values of a stack of N frames: gain, bias and gamma (N,),
    standard normal noise (N, H, W)."""

    gain: torch.Tensor
    bias: torch.Tensor
    gamma: torch.Tensor
    noise: torch.Tensor


def sensor_draws(shape, cfg: SensorConfig = SensorConfig(), generator: torch.Generator | None = None,
                 device="cuda") -> SensorDraws:
    """Draws for (N, H, W) frames: gain log-uniform in exp(+-max_gain), bias
    uniform in +-max_bias, gamma log-uniform in (1 + max_gamma)^(+-1)."""
    n = shape[0]

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)

    lg = math.log1p(cfg.max_gamma)
    return SensorDraws(
        gain=torch.exp(uniform(-cfg.max_gain, cfg.max_gain)),
        bias=uniform(-cfg.max_bias, cfg.max_bias),
        gamma=torch.exp(uniform(-lg, lg)),
        noise=torch.randn(tuple(shape), generator=generator, device=device),
    )


def apply_sensor_nuisance(images: torch.Tensor, draws: SensorDraws, cfg: SensorConfig = SensorConfig()):
    """(N, H, W) frames in [0, 255] -> photometrically shifted frames."""
    H, W = images.shape[-2:]
    dev = images.device
    ys = (torch.arange(H, dtype=torch.float32, device=dev) - (H - 1) / 2.0) / (H / 2.0)
    xs = (torch.arange(W, dtype=torch.float32, device=dev) - (W - 1) / 2.0) / (W / 2.0)
    r2 = (ys[:, None] ** 2 + xs[None, :] ** 2) / 2.0  # 1.0 at the corners
    vig = 1.0 - cfg.vignette * r2
    per_frame = lambda a: a.reshape(-1, 1, 1)
    x = torch.clamp(images.float() / 255.0, 0.0, 1.0) ** per_frame(draws.gamma) * 255.0
    x = x * per_frame(draws.gain) * vig + per_frame(draws.bias)
    noise_std = cfg.shot_sigma * torch.sqrt(torch.clamp(x, 0.0, 255.0) / 255.0)
    noise = draws.noise * torch.sqrt(noise_std ** 2 + cfg.read_sigma ** 2)
    return torch.clamp(x + noise, 0.0, 255.0)


def sensor_shift_stack(images: torch.Tensor, generator: torch.Generator | None = None,
                       cfg: SensorConfig = SensorConfig(), draws: SensorDraws | None = None) -> torch.Tensor:
    """Per-frame sensor nuisances over an (N, H, W) stack."""
    if draws is None:
        draws = sensor_draws(images.shape, cfg, generator, images.device)
    return apply_sensor_nuisance(images, draws, cfg)
