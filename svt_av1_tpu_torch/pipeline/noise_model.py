"""Film-grain noise estimation: flat-block extraction + AR model fit +
intensity-binned scaling curve.

The reference fits its grain model from (raw, denoised) frame pairs
(noise_model.c:1756 svt_aom_noise_model_update; flat-block finder
svt_aom_flat_block_finder_run).  This module is the single-frame
analog: low-texture blocks are located by plane-fit residual tests,
the pooled residuals drive a least-squares AR fit over the AV1 AR
support (ops/film_grain._pred_positions), and the per-intensity noise
sigmas become scaling points calibrated against the ACTUAL synthesized
grain template's sigma, so apply_grain reproduces the measured noise
energy.
"""
from __future__ import annotations

import numpy as np

from ..ops.film_grain import (FilmGrainParams, _pred_positions,
                              generate_grain)

BLOCK = 32


def _plane_residuals(plane: np.ndarray, block: int = BLOCK):
    """Per-block plane-fit residuals: (residuals [n, b, b] float,
    means [n], flat_score [n]) for every full block of the plane.

    flat_score is the ratio of high-frequency to total residual energy
    — pure sensor noise / grain scores near the white-noise value,
    structured texture scores low."""
    h, w = plane.shape
    nby, nbx = h // block, w // block
    ys, xs = np.mgrid[0:block, 0:block]
    A = np.stack([np.ones(block * block), ys.ravel() / block,
                  xs.ravel() / block], axis=1)
    pinv = np.linalg.pinv(A)                    # [3, b*b]
    blocks = plane[:nby * block, :nbx * block].astype(np.float64) \
        .reshape(nby, block, nbx, block).transpose(0, 2, 1, 3) \
        .reshape(-1, block * block)
    coefs = blocks @ pinv.T                     # [n, 3]
    resid = blocks - coefs @ A.T                # [n, b*b]
    means = blocks.mean(axis=1)
    r2 = resid.reshape(-1, block, block)
    # high-frequency energy: residual of the 2x2 box-smoothed signal
    sm = (r2[:, :-1, :-1] + r2[:, :-1, 1:] + r2[:, 1:, :-1]
          + r2[:, 1:, 1:]) / 4.0
    hf = r2[:, :-1, :-1] - sm
    e_tot = (r2 ** 2).mean(axis=(1, 2)) + 1e-9
    e_hf = (hf ** 2).mean(axis=(1, 2))
    # white noise: E[(x - box4(x))^2] = 3/4 sigma^2 -> ratio 0.75
    score = e_hf / e_tot
    return r2, means, score


def _select_flat(score: np.ndarray, e_floor: np.ndarray,
                 min_blocks: int = 8):
    """Indices of noise-like blocks: high HF ratio (near-white
    residual), trimmed to the flattest half by residual energy."""
    idx = np.nonzero(score > 0.55)[0]
    if len(idx) < min_blocks:
        idx = np.argsort(-score)[:min_blocks]
    # drop high-energy outliers (edges that slipped the ratio test)
    e = e_floor[idx]
    keep = e <= (np.median(e) * 4.0 + 1e-9)
    return idx[keep] if keep.any() else idx


def _ar_fit(residuals: np.ndarray, lag: int):
    """Least-squares AR fit over the AV1 support: residuals [n, b, b].
    Returns (coeffs float [k], innovation std)."""
    pos = _pred_positions(lag)
    n, b, _ = residuals.shape
    m = b - 2 * lag
    X = np.empty((n * m * m, len(pos)))
    for k, (dr, dc, _) in enumerate(pos):
        X[:, k] = residuals[:, lag + dr:lag + dr + m,
                            lag + dc:lag + dc + m].reshape(-1)
    yv = residuals[:, lag:lag + m, lag:lag + m].reshape(-1)
    coef, *_ = np.linalg.lstsq(X, yv, rcond=None)
    innov = yv - X @ coef
    return coef, float(innov.std())


def _quantize_coeffs(coef: np.ndarray, shift: int = 6):
    q = np.clip(np.round(coef * (1 << shift)), -128, 127).astype(int)
    return [int(v) for v in q]


def fit_film_grain(y: np.ndarray, seed: int, strength: int = 8,
                   lag: int = 2, bd: int = 8,
                   u: np.ndarray | None = None,
                   v: np.ndarray | None = None):
    """Fit FilmGrainParams from one source frame (luma-driven; chroma
    scaling from pooled chroma noise sigma).  Returns None when the
    frame carries no measurable noise.  ``strength``/8 scales the
    synthesized grain energy (film_grain_denoise_strength semantics)."""
    res, means, score = _plane_residuals(np.asarray(y, np.float64))
    idx = _select_flat(score, (res ** 2).mean(axis=(1, 2)))
    if len(idx) == 0:
        return None
    flat = res[idx]
    coef, _ = _ar_fit(flat, lag)
    qcoef = _quantize_coeffs(coef)

    # per-intensity sigma -> scaling points (<= 8 bins with data).
    # The scaling-point x domain is 8-bit (0..255) regardless of the
    # source bit depth: normalize block means before binning.
    bins = np.clip((means[idx] / (32.0 * (1 << (bd - 8)))).astype(int),
                   0, 7)
    pts = []
    sig_all = float(flat.std())
    for b in range(8):
        sel = bins == b
        if sel.sum() >= 2:
            pts.append((b * 32 + 16, float(flat[sel].std())))
    if not pts:
        pts = [(128, sig_all)]

    # calibrate against the actual synthesized template's sigma
    probe = FilmGrainParams(
        apply_grain=True, grain_seed=seed & 0xFFFF,
        scaling_points_y=[(0, 64), (255, 64)],
        ar_coeff_lag=lag, ar_coeffs_y=qcoef,
        ar_coeffs_cb=[0] * (len(qcoef) + 1),
        ar_coeffs_cr=[0] * (len(qcoef) + 1))
    tmpl, _, _ = generate_grain(probe, bd)
    sig_t = float(tmpl[3:, 3:-3].std())
    if sig_t < 1e-3:
        return None

    def to_scale(sig):
        # apply_grain: noise = grain * lut(luma) >> scaling_shift(8);
        # lut value == point value (piecewise-linear, 0..255)
        return int(np.clip(round(sig / sig_t * 256.0 * strength / 8.0),
                           0, 255))

    spts = [(int(np.clip(x, 0, 255)), to_scale(s)) for x, s in pts]
    # points must be strictly increasing in x; pad the curve ends
    spts = sorted(dict(spts).items())
    if len(spts) == 1:
        x0, s0 = spts[0]
        spts = [(0, s0), (255, s0)]
    if all(s == 0 for _, s in spts):
        return None

    s_uv = 0
    if u is not None and v is not None:
        su = _plane_residuals(np.asarray(u, np.float64), 16)
        sv = _plane_residuals(np.asarray(v, np.float64), 16)
        iu = _select_flat(su[2], (su[0] ** 2).mean(axis=(1, 2)))
        iv = _select_flat(sv[2], (sv[0] ** 2).mean(axis=(1, 2)))
        sig_uv = 0.5 * (float(su[0][iu].std()) + float(sv[0][iv].std()))
        s_uv = to_scale(sig_uv)

    return FilmGrainParams(
        apply_grain=True,
        grain_seed=seed & 0xFFFF,
        scaling_points_y=spts,
        scaling_points_cb=[(0, s_uv), (255, s_uv)] if s_uv else [],
        scaling_points_cr=[(0, s_uv), (255, s_uv)] if s_uv else [],
        ar_coeff_lag=lag,
        ar_coeffs_y=qcoef,
        ar_coeffs_cb=[0] * (len(qcoef) + 1),
        ar_coeffs_cr=[0] * (len(qcoef) + 1),
    )
