"""Seeded image-like planes: smooth waves plus Gaussian noise.

Each plane is ``128 + 60 sin(a y + p) cos(b x + q) + 30 sin(c x + d y + r)``
plus noise of standard deviation ``noise``, clipped to [0, 255] and
rounded down to uint8.  The wave frequencies (radians a pixel) and phases
are drawn from the seed for each plane, so the planes of a pool differ;
the noise level is the configuration's, chosen once so that the archive's
bits a pixel lie near those of the configuration's source image.  The
planes are made on ``device`` by one ``torch.Generator``: the same seed
gives the same planes on one kind of device.
"""

from __future__ import annotations

import math

__all__ = ["natural_planes", "generator_seed"]


def generator_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one use (``stream``) of a run's seed."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(stream) * 0xBF58476D1CE4E5B9) % (1 << 63)


def natural_planes(seed: int, count: int, h: int, w: int, noise: float, device="cpu"):
    """``count`` uint8 ``[h, w]`` planes as a ``[count, h, w]`` tensor on
    ``device``."""
    import torch

    g = torch.Generator(device=device).manual_seed(generator_seed(seed, 1))
    u = torch.rand((count, 7), generator=g, device=device, dtype=torch.float64).tolist()
    out = torch.empty((count, h, w), dtype=torch.uint8, device=device)
    y = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    x = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    for i, (a, b, c, d, p, q, r) in enumerate(u):
        # 0.5 to 1.5 periods of the first wave over 1080 rows, 0.7 to 2.2 over
        # 1920 columns; the second wave two to four times finer.
        fa, fb = (3 + 6 * a) / 1080, (4.5 + 9 * b) / 1920
        fc, fd = (12 + 18 * c) / 1920, (2 + 4 * d) / 1080
        base = 128 + 60 * torch.sin(fa * y + 2 * math.pi * p) * torch.cos(fb * x + 2 * math.pi * q)
        base = base + 30 * torch.sin(fc * x + fd * y + 2 * math.pi * r)
        base += noise * torch.randn((h, w), generator=g, device=device)
        out[i] = base.clamp_(0, 255).to(torch.uint8)
    return out
