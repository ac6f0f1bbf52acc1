"""The 10-bit clip with real motion that the port's 10-bit stream tests
code (tests/test_torch_tenbit_*.py)."""
import numpy as np


def moving_clip10(w, h, n, seed=3):
    """A 10-bit 4:2:0 clip with real motion: chip_smoke.py's synth_clip
    (a noise texture moving by (1.7, 3.1) pixels a frame over a
    background, a moving rectangle) scaled to 10 bits, its low bits drawn
    from the same generator."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    tex = rng.normal(0, 12.0, (h * 2, w * 2))
    frames = []
    for i in range(n):
        dx, dy = int(3.1 * i) % w, int(1.7 * i) % h
        y = (90 + 50 * np.sin((xx + 2 * i) / 37) + 25 * np.cos(yy / 29)
             + tex[dy:dy + h, dx:dx + w])
        x0, y0 = (40 + 5 * i) % (w - 80), (30 + 3 * i) % (h - 60)
        y[y0:y0 + 60, x0:x0 + 80] = 190 - (xx[:60, :80] % 17) * 4
        y = (y + rng.normal(0, 2, (h, w))).clip(0, 255)
        u = (120 + 30 * np.sin((yy[:h // 2, :w // 2] + i) / 23)).clip(0, 255)
        v = (130 - 30 * np.cos((xx[:h // 2, :w // 2] + 2 * i) / 31)) \
            .clip(0, 255)
        frames.append(tuple(
            (np.floor(p).astype(np.uint16) << 2)
            | rng.integers(0, 4, p.shape, dtype=np.uint16) for p in (y, u, v)))
    return frames
