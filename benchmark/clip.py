"""The titles' pictures: a frozen copy of ``chip_smoke.py``'s ``synth_clip``
recipe (``chip_smoke.py:283``), written in torch so that set-up makes a
title on the card in a few large calls.

Moving textured background, gradients, a sharp-edged moving box and mild
sensor noise, 4:2:0 at the configuration's bit depth.  The parameters
come from the traffic file's ``content``, in 8-bit units; the random
draws come from a ``torch.Generator`` seeded with the title's seed on the
device that makes them.  A title of more than 8 bits is the 8-bit
title's float planes scaled by 2^(bit_depth - 8) before they are
truncated, so that its gradients and noise fill the low bits and, shifted
right, it is the 8-bit title sample for sample.
"""
from __future__ import annotations

import numpy as np
import torch


def title_seed(seed: int, channel: int) -> int:
    """One title per (run seed, channel), within torch's 64-bit seeds."""
    return (int(seed) * 64 + channel) % (1 << 63)


def make_title(width: int, height: int, n: int, seed: int, content: dict,
               device, chunk: int = 8, bit_depth: int = 8
               ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """``n`` pictures (y, u, v) as host arrays of ``bit_depth``-bit
    samples (uint8 at 8 bits, uint16 above), made ``chunk`` pictures at a
    time so that the float planes stay small."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=device)
    yy = torch.arange(height, **f32).view(1, height, 1)
    xx = torch.arange(width, **f32).view(1, 1, width)
    tex = torch.randn((2 * height, 2 * width), generator=g, **f32) \
        * content["texture_sigma"]
    bw, bh = content["box"]
    box = 190 - (torch.arange(bw, **f32) % 17).view(1, bw) * 4
    out = []
    for k0 in range(0, n, chunk):
        ks = range(k0, min(k0 + chunk, n))
        i = torch.tensor(list(ks), **f32).view(-1, 1, 1)
        # the background's texture moves by whole pixels a picture
        y = torch.stack([
            tex[int(content["move_y"] * k) % height:][:height,
                int(content["move_x"] * k) % width:][:, :width]
            for k in ks])
        y += 90 + 50 * torch.sin((xx + content["wave_x"] * i) / 37) \
            + 25 * torch.cos(yy / 29)
        for j, k in enumerate(ks):
            x0 = (40 + content["box_x"] * k) % (width - bw)
            y0 = (30 + content["box_y"] * k) % (height - bh)
            y[j, y0:y0 + bh, x0:x0 + bw] = box
        y += torch.randn(y.shape, generator=g, **f32) \
            * content["noise_sigma"]
        hy, hx = yy[:, : height // 2], xx[..., : width // 2]
        u = 120 + 30 * torch.sin((hy + i) / 23) + 0 * hx
        v = 130 - 30 * torch.cos((hx + 2 * i) / 31) + 0 * hy
        planes = [samples(p, bit_depth) for p in (y, u, v)]
        out += [(planes[0][j], planes[1][j], planes[2][j])
                for j in range(len(ks))]
    return out


def samples(plane, bit_depth: int) -> np.ndarray:
    """A float plane in 8-bit units as host samples of ``bit_depth``
    bits: scaled by 2^(bit_depth - 8) (exact in float32), clamped to the
    range and truncated."""
    if bit_depth == 8:
        return plane.clamp(0, 255).to(torch.uint8).cpu().numpy()
    top = (1 << bit_depth) - 1
    return (plane * (1 << (bit_depth - 8))).clamp(0, top) \
        .to(torch.int16).cpu().numpy().view(np.uint16)
