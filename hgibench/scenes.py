"""Seeded scenes whose local activity varies: the waves of
:mod:`.planes` plus Gaussian noise whose standard deviation follows a
smooth seeded field.

The field is ``u = (1 + sin(a y + p) sin(b x + q)) / 2`` in [0, 1], its
periods drawn from the seed between ``PERIODS`` pixels, and the noise's
standard deviation at a pixel is ``sigma_lo (sigma_hi / sigma_lo) ** u``.
A tile of 512 pixels then holds two fifths to two thirds of a period,
so its noise grows or fades across it: the ctx coder of ``.thgi``, whose
contexts follow the local activity, codes such tiles smaller than a
static table does, where a plane of one noise level everywhere lets the
static rANS win every tile.  Over a scene of several periods each way
the field averages out alike for every seed, so the archive's bits a
pixel barely move with the seed.  The scenes are made on ``device`` by
one ``torch.Generator``: the same seed gives the same scenes on one kind
of device.
"""

from __future__ import annotations

import math

from .planes import generator_seed, natural_planes

__all__ = ["PERIODS", "race_scenes"]

PERIODS = (768.0, 1280.0)  # pixels a period of the field, each way


def race_scenes(seed: int, count: int, h: int, w: int, sigma_lo: float, sigma_hi: float,
                device="cpu"):
    """``count`` uint8 ``[h, w]`` scenes as a ``[count, h, w]`` tensor on
    ``device``."""
    import torch

    waves = natural_planes(seed, count, h, w, 0.0, device)
    g = torch.Generator(device=device).manual_seed(generator_seed(seed, 2))
    u = torch.rand((count, 4), generator=g, device=device, dtype=torch.float64).tolist()
    y = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    x = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    lo, hi = PERIODS
    ratio = math.log(sigma_hi / sigma_lo)
    out = torch.empty((count, h, w), dtype=torch.uint8, device=device)
    for i, (a, b, p, q) in enumerate(u):
        fy, fx = 2 * math.pi / (lo + (hi - lo) * a), 2 * math.pi / (lo + (hi - lo) * b)
        field = torch.sin(fy * y + 2 * math.pi * p) * torch.sin(fx * x + 2 * math.pi * q)
        sigma = torch.exp((0.5 + 0.5 * field) * ratio) * sigma_lo
        plane = torch.randn((h, w), generator=g, device=device) * sigma
        plane += waves[i]
        out[i] = plane.clamp_(0, 255).to(torch.uint8)
    return out
