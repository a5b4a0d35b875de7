"""Seeded RGB photographs for the color cell: a luma field, chroma fields
a channel, and texture whose correlation across the channels is set for
each image.

An image is ``h x w`` (landscape) or ``w x h`` (portrait).  Its channel
``c`` is ``g_c (L + s sqrt(rho) T) + C_c + s sqrt(1 - rho) N_c``, clipped
to [0, 255] and rounded down:

* ``L`` the waves of :mod:`.planes`, their swing about 128 scaled by
  ``contrast``;
* ``C_c`` a smooth chroma wave of amplitude up to ``chroma`` (none in
  green), ``g_c`` a gain within ``gain`` of 1 (red's ``g``, green's 1,
  blue's ``2 - g``);
* ``T`` texture shared by the three channels and ``N_c`` texture of the
  channel alone, both unit Gaussian noise;
* ``s`` the image's texture level, ``sigma_lo (sigma_hi / sigma_lo) ** u``
  with ``u`` a seeded smooth field in [0, 1] as in :mod:`.scenes` (of
  whole periods over the image, so that its mean is 1/2 for every seed),
  times a factor of the image from ``scale``;
* ``rho`` the correlation of the channels' texture: green-delta stores
  ``R - G``, whose texture is ``2 (1 - rho)`` of a channel's in variance,
  so it wins where ``rho`` is high, as in natural photographs, and
  identity where it is low.

Every suite holds the same ``count`` settings of ``rho``, the texture
factor, the gains and the chroma amplitudes: ``identity_images`` settings
take ``rho`` from ``rho_identity`` and the others from ``rho_gdelta``, each
quantity a ladder of values evenly spaced over its range, the ladders
paired in a fixed mix.  The seed deals the settings to the images, picks
the ``portraits`` and draws the waves, the fields and the noise, so that
the suite's bits a pixel barely move with the seed.  The images are made
on ``device`` by one ``torch.Generator``: the same seed gives the same
images on one kind of device.
"""

from __future__ import annotations

import math

from .planes import generator_seed, natural_planes

__all__ = ["photo_suite"]

WAVES = (2, 4)  # whole periods of the texture level's field over the image, each way
CHROMA_WAVES = (1, 2)  # and of a chroma wave


def _wave(g, y, x, device, lo: int, hi: int):
    """A seeded smooth wave ``sin(fy y + p) sin(fx x + q)`` in [-1, 1], of
    ``lo`` to ``hi`` whole periods over the image each way, so that its
    mean over the image is 0 for every seed."""
    import torch

    ky, kx = torch.randint(lo, hi + 1, (2,), generator=g, device=device).tolist()
    p, q = torch.rand(2, generator=g, device=device, dtype=torch.float64).tolist()
    fy, fx = 2 * math.pi * ky / y.shape[0], 2 * math.pi * kx / x.shape[1]
    return torch.sin(fy * y + 2 * math.pi * p) * torch.sin(fx * x + 2 * math.pi * q)


def _ladder(n: int, lo_hi, stride: int = 1) -> list:
    """``n`` values evenly spaced over ``[lo, hi]``, a cell's middle each,
    the ``k``-th being rank ``stride k mod n`` (``stride`` prime to ``n``):
    ladders of different strides pair their values in a fixed mix."""
    lo, hi = (float(v) for v in lo_hi)
    return [lo + (hi - lo) * ((stride * k) % n + 0.5) / n for k in range(n)]


def photo_suite(seed: int, photo: dict, h: int, w: int, device="cpu"):
    """The suite ``photo`` describes (``count``, ``portraits``,
    ``identity_images``, ``contrast``, ``sigma_lo``, ``sigma_hi``, ``scale``,
    ``chroma``, ``gain``, ``rho_gdelta``, ``rho_identity``) as uint8
    ``[H, W, 3]`` tensors on ``device``."""
    import torch

    count, n_identity = int(photo["count"]), int(photo["identity_images"])
    rhos = (_ladder(n_identity, photo["rho_identity"])
            + _ladder(count - n_identity, photo["rho_gdelta"]))
    strides = [k for k in (5, 7, 11, 13, 17, 19, 23) if math.gcd(k, count) == 1] + [1, 1, 1]
    scales = _ladder(count, photo["scale"], strides[0])
    gain = float(photo["gain"])
    gains = _ladder(count, (1 - gain, 1 + gain), strides[1])
    amps = _ladder(count, (0.0, float(photo["chroma"])), strides[2])
    lo_s, hi_s = float(photo["sigma_lo"]), float(photo["sigma_hi"])
    contrast = float(photo["contrast"])
    g = torch.Generator(device=device).manual_seed(generator_seed(seed, 3))
    slots = torch.randperm(count, generator=g, device=device).tolist()
    portraits = set(torch.randperm(count, generator=g, device=device).tolist()[
        : int(photo["portraits"])])
    images = []
    for i in range(count):
        ih, iw = (w, h) if i in portraits else (h, w)
        waves = natural_planes(generator_seed(seed, 16 + i), 1, ih, iw, 0.0, device)[0].float()
        luma = 128 + contrast * (waves - 128)
        y = torch.arange(ih, device=device, dtype=torch.float32)[:, None]
        x = torch.arange(iw, device=device, dtype=torch.float32)[None, :]
        k = slots[i]
        rho = rhos[k]
        u = 0.5 + 0.5 * _wave(g, y, x, device, *WAVES)
        s = scales[k] * lo_s * torch.exp(u * math.log(hi_s / lo_s))
        shared = torch.randn((ih, iw), generator=g, device=device) * s * math.sqrt(rho)
        out = torch.empty((ih, iw, 3), dtype=torch.uint8, device=device)
        for c, gc in enumerate((gains[k], 1.0, 2 - gains[k])):
            amp = (amps[k], 0.0, amps[count - 1 - k])[c]
            plane = gc * (luma + shared) + amp * _wave(g, y, x, device, *CHROMA_WAVES)
            plane += torch.randn((ih, iw), generator=g, device=device) * s * math.sqrt(1 - rho)
            out[:, :, c] = plane.clamp_(0, 255).to(torch.uint8)
        images.append(out)
    return images
