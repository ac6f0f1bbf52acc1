"""Palette mode: syntax, prediction, and the encoder-side k-means
search (screen-content tool family).

Behavioral reference: spec 5.11.46 palette_mode_info / 5.11.49
palette_tokens; decoder-side semantics cross-checked against
EbDecParseBlock.c:143 (read_palette_colors_y), EbDecParseInterBlock.c:
2249 (get_palette_color_context) and palette_tokens:2298.  Encoder
k-means mirrors the shape of the reference's av1_k_means (palette.c:632)
without porting it: numpy centroid iteration over the block pixels.
"""
from __future__ import annotations

import numpy as np

from ..entropy.tables import table

PALETTE_MIN_SIZE = 2
PALETTE_MAX_SIZE = 8

# palette_color_index_context_lookup (EbCabacContextModel.c:3280)
_CTX_LOOKUP = (-1, -1, 0, -1, -1, 4, 3, 2, 1)
_NEIGH_WEIGHTS = (2, 1, 2)       # left, top-left, top
_HASH_MULT = (1, 2, 2)


def allow_palette(allow_sct: bool, bw: int, bh: int) -> bool:
    return bool(allow_sct) and 8 <= bw <= 64 and 8 <= bh <= 64


def bsize_ctx(bw: int, bh: int) -> int:
    """get_palette_bsize_ctx: num_pels_log2 - 6."""
    return (bw * bh).bit_length() - 1 - 6


# --------------------------------------------------------------------------
# ns() coding (spec 4.10.7 decode_unsigned_subexp? no - ns: 4.10.5) for
# the first color index
# --------------------------------------------------------------------------

def write_ns(io, value: int, n: int) -> None:
    w = n.bit_length() - 1
    m = (1 << (w + 1)) - n
    if value < m:
        io.literal(value, w)
    else:
        v = value + m
        io.literal(v >> 1, w)
        io.literal(v & 1, 1)


def read_ns(io, n: int) -> int:
    w = n.bit_length() - 1
    m = (1 << (w + 1)) - n
    v = io.literal(None, w)
    if v < m:
        return v
    return (v << 1) - m + io.literal(None, 1)


# --------------------------------------------------------------------------
# Color cache (av1_get_palette_cache) + color transmission
# --------------------------------------------------------------------------

def get_cache(codec, mi_row: int, mi_col: int) -> list:
    """Merged sorted color cache from the above (same 64-px SB row
    only) and left neighbors."""
    above = None
    if mi_row > codec.tile[0] and (mi_row * 4) % 64 != 0:
        if codec.pal_size[mi_row - 1, mi_col] > 0:
            n = int(codec.pal_size[mi_row - 1, mi_col])
            above = [int(v) for v in
                     codec.pal_colors[mi_row - 1, mi_col][:n]]
    left = None
    if mi_col > codec.tile[1] and codec.pal_size[mi_row, mi_col - 1] > 0:
        n = int(codec.pal_size[mi_row, mi_col - 1])
        left = [int(v) for v in codec.pal_colors[mi_row, mi_col - 1][:n]]
    if not above and not left:
        return []
    a = above or []
    l = left or []
    out = []

    def add(v):
        if not out or out[-1] != v:
            out.append(v)

    ai = li = 0
    while ai < len(a) and li < len(l):
        if l[li] < a[ai]:
            add(l[li]); li += 1
        else:
            v = a[ai]
            add(v); ai += 1
            if li < len(l) and l[li] == v:
                li += 1
    while ai < len(a):
        add(a[ai]); ai += 1
    while li < len(l):
        add(l[li]); li += 1
    return out


def _ceil_log2(x: int) -> int:
    return 0 if x < 2 else (x - 1).bit_length()


def write_colors_y(io, cache: list, colors: list, bd: int) -> None:
    """Transmit the sorted luma palette given the neighbor cache
    (read_palette_colors_y encoder twin): reuse bits over the cache,
    then the non-cached colors with shrinking-delta coding."""
    n = len(colors)
    remaining = set(colors)
    n_cached = 0
    for i in range(len(cache)):
        if n_cached >= n:
            break
        hit = cache[i] in remaining
        io.literal(int(hit), 1)
        if hit:
            remaining.discard(cache[i])
            n_cached += 1
    rest = sorted(remaining)
    if not rest:
        return
    io.literal(rest[0], bd)
    if len(rest) > 1:
        min_bits = bd - 3
        deltas = [rest[i] - rest[i - 1] for i in range(1, len(rest))]
        need = max(max(d - 1, 0).bit_length() for d in deltas)
        bits = int(np.clip(need, min_bits, min_bits + 3))
        io.literal(bits - min_bits, 2)
        rng = (1 << bd) - rest[0] - 1
        for k, d in enumerate(deltas):
            io.literal(d - 1, bits)
            rng -= d
            bits = min(bits, _ceil_log2(rng))


def read_colors_y(io, cache: list, n: int, bd: int) -> list:
    cached = []
    for i in range(len(cache)):
        if len(cached) >= n:
            break
        if io.literal(None, 1):
            cached.append(cache[i])
    if len(cached) == n:
        return list(cached)
    trans = [io.literal(None, bd)]
    if len(cached) + len(trans) < n:
        min_bits = bd - 3
        bits = min_bits + io.literal(None, 2)
        rng = (1 << bd) - trans[0] - 1
        while len(cached) + len(trans) < n:
            delta = io.literal(None, bits) + 1
            prev = trans[-1]
            val = int(np.clip(prev + delta, 0, (1 << bd) - 1))
            trans.append(val)
            rng -= val - prev
            bits = min(bits, _ceil_log2(rng))
    return sorted(cached + trans)


# --------------------------------------------------------------------------
# Color index map (palette_tokens)
# --------------------------------------------------------------------------

def color_context(cmap: np.ndarray, r: int, c: int, size: int):
    """(ctx, color_order): get_palette_color_context."""
    neigh = (int(cmap[r, c - 1]) if c > 0 else -1,
             int(cmap[r - 1, c - 1]) if r > 0 and c > 0 else -1,
             int(cmap[r - 1, c]) if r > 0 else -1)
    scores = [0] * (PALETTE_MAX_SIZE + 10)
    for i in range(3):
        if neigh[i] >= 0:
            scores[neigh[i]] += _NEIGH_WEIGHTS[i]
    order = list(range(PALETTE_MAX_SIZE))
    for i in range(3):
        max_score = scores[i]
        max_id = i
        for j in range(i + 1, size):
            if scores[j] > max_score:
                max_score = scores[j]
                max_id = j
        if max_id != i:
            mo = order[max_id]
            for k in range(max_id, i, -1):
                scores[k] = scores[k - 1]
                order[k] = order[k - 1]
            scores[i] = max_score
            order[i] = mo
    h = sum(scores[i] * _HASH_MULT[i] for i in range(3))
    return _CTX_LOOKUP[h], order


def code_color_map(io, fc, cmap, bw: int, bh: int, size: int,
                   plane_type: int, on_w: int, on_h: int):
    """Wavefront-coded color index map.  Encoder: ``cmap`` holds the
    indices to code; decoder: ``cmap`` is filled in.  Returns the
    (block-extended) map."""
    cdf_tab = fc.palette_uv_color_index if plane_type \
        else fc.palette_y_color_index
    if io.is_decoder:
        cmap = np.zeros((bh, bw), np.int32)
        cmap[0, 0] = read_ns(io, size)
    else:
        write_ns(io, int(cmap[0, 0]), size)
    for i in range(1, on_h + on_w - 1):
        for j in range(min(i, on_w - 1), max(0, i - on_h + 1) - 1, -1):
            r, c = i - j, j
            ctx, order = color_context(cmap, r, c, size)
            cdf = cdf_tab[size - PALETTE_MIN_SIZE][ctx]
            if io.is_decoder:
                sym = io.symbol(None, cdf, size)
                cmap[r, c] = order[sym]
            else:
                io.symbol(order.index(int(cmap[r, c])), cdf, size)
    # extend to the (possibly off-screen) block extent
    for r in range(on_h):
        cmap[r, on_w:bw] = cmap[r, on_w - 1]
    cmap[on_h:bh, :] = cmap[on_h - 1, :]
    return cmap


# --------------------------------------------------------------------------
# Encoder search
# --------------------------------------------------------------------------

def kmeans_palette(block: np.ndarray, max_size: int = PALETTE_MAX_SIZE,
                   iters: int = 6):
    """(colors sorted, map, sse) for the best k in 2..max_size by a
    simple elbow rule, or None when the block has too many distinct
    values to benefit (av1_k_means shape, palette.c:632)."""
    px = block.reshape(-1).astype(np.float64)
    uniq = np.unique(px)
    if len(uniq) < 2:
        return None
    best = None
    for k in range(PALETTE_MIN_SIZE, min(max_size, len(uniq)) + 1):
        # init centroids at quantiles
        cent = np.quantile(uniq, np.linspace(0, 1, k))
        for _ in range(iters):
            idx = np.argmin(np.abs(px[:, None] - cent[None, :]), axis=1)
            for ci in range(k):
                sel = idx == ci
                if sel.any():
                    cent[ci] = px[sel].mean()
        cent = np.unique(np.round(cent).astype(np.int32))
        if len(cent) < 2:
            continue
        idx = np.argmin(np.abs(px[:, None] - cent[None, :]), axis=1)
        err = px - cent[idx]
        sse = float((err * err).sum())
        # rate proxy: per-pixel index entropy + color signaling
        bits = px.size * np.log2(len(cent)) * 0.6 + len(cent) * 10 + 16
        if best is None or sse + bits < best[0]:
            best = (sse + bits, cent, idx, sse)
    if best is None:
        return None
    _, cent, idx, sse = best
    return ([int(v) for v in cent],
            idx.reshape(block.shape).astype(np.int32), sse)
