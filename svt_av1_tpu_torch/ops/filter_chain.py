"""Per-frame filter chain on the device: DLF level search + apply, then
CDEF direction, strength search + apply (port of
svt_av1_tpu/ops/filter_chain.py).

The recon planes go up once and come back once per frame; in between
the chain runs the deblocking kernel (K2), the CDEF direction kernel
(K3) and the CDEF filter kernel (K4, search then apply) on the codec's
device, the plain PyTorch versions for a CPU device.  The planes are
bit-identical to the reference's sequential host filters run at the
searched level and strengths.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cdef as cdef_ops
from . import dlf as dlf_ops


def dlf_cdef_chain(codec) -> bool:
    """Run the chain for one frame; fills fh.filter_level and
    fh.cdef_*_strengths and replaces codec.recon.  Returns True when it
    ran, False when the caller must use the sequential path."""
    fh, seq = codec.fh, codec.seq
    if codec.source is None or codec.num_planes != 3:
        return False
    if fh.coded_lossless or fh.allow_intrabc:
        return False
    if seq.enable_restoration:          # LR needs the deblocked copy
        return False
    if not seq.enable_cdef:
        return False
    if max(fh.filter_level) == 0:
        return False
    if getattr(fh, "dlf_level_searched", False):
        return False
    ns =cdef_ops.nonskip_grid(codec.skips, codec.mi_rows, codec.mi_cols)
    if not ns.any():
        return False

    dev = codec.device
    cands = dlf_ops.level_candidates(max(fh.filter_level))
    fast = bool(getattr(codec, "cdef_fast", False))
    pri_set = cdef_ops.PRI_SET_FAST if fast else cdef_ops.PRI_SET
    sec_set = cdef_ops.SEC_SET_FAST if fast else cdef_ops.SEC_SET
    bd = seq.bit_depth
    fw, fh_px = codec.mi_cols * 4, codec.mi_rows * 4
    grids = [(codec.tx_w_grid[p], codec.tx_h_grid[p], codec.skip_grid[p],
              codec.bedge_x[p], codec.bedge_y[p]) for p in range(3)]
    vis = [((fh.frame_width + (1 if p else 0)) >> (1 if p else 0),
            (fh.frame_height + (1 if p else 0)) >> (1 if p else 0))
           for p in range(3)]
    srcs = codec.device_source()
    recon = [torch.from_numpy(np.ascontiguousarray(codec.recon[p],
                                                   np.int32)).to(dev)
             for p in range(3)]
    dlf_out, level = dlf_ops.search_apply(
        recon, srcs[0], dlf_ops.plane_params(grids, vis, dev), vis, cands,
        fh.sharpness, bd)
    out, ystr, uvstr = cdef_ops.search_apply(
        srcs, dlf_out, torch.from_numpy(ns).to(dev), fw, fh_px,
        fh.cdef_damping, bd, pri_set, sec_set)
    for p in range(3):
        codec.recon[p] = out[p].cpu().numpy()
    fh.filter_level = (level, level)
    fh.filter_level_uv = (level, level)
    fh.dlf_level_searched = True
    fh.cdef_y_strengths = (ystr,)
    fh.cdef_uv_strengths = (uvstr,)
    return True
