"""Python front end of the native tile coder (coder_native.c), for key
frames (``try_encode_tiles_native``) and inter frames
(``try_encode_tiles_native_inter``).

Replays a precomputed frame plan (the batched TPU decision pass) through
the conformant coding loop in ONE C call per tile — the TPU build's
serial host stage (SURVEY §7), replacing the per-block Python walk for
the fast presets.  A dry-run of the partition traversal flattens the
decider's plan into sequences the C walker consumes; the C path is
bit-identical to FrameCodec._walk_superblocks for the supported feature
envelope (tests/test_native_coder.py).
"""
from __future__ import annotations

import numpy as np

from ..constants import FrameType, PredictionMode, TxType, TX_WIDTH, TX_HEIGHT
from ..entropy import coeffs as cf
from ..entropy.tables import table
from ..ops import quant as qz
from ..kernels.build import load_c_extension
from . import block_plan

_cn = load_c_extension("coder_native")

_SIZE_PAIRS = ((8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16),
               (32, 32))

_CONSTS = None


def available() -> bool:
    return _cn is not None and block_plan.available()


def _consts():
    global _CONSTS
    if _CONSTS is None:
        n_ts = 19
        tx_w = np.array([TX_WIDTH[t] for t in range(n_ts)], np.int32)
        tx_h = np.array([TX_HEIGHT[t] for t in range(n_ts)], np.int32)
        txs = np.array([cf.txs_ctx(t) for t in range(n_ts)], np.int32)
        shp = np.array([cf._tx_shape(t) for t in range(n_ts)], np.int32)
        ems = np.array([cf.eob_multi_size(t) for t in range(n_ts)], np.int32)
        _CONSTS = (
            np.ascontiguousarray(table("sm_weight_arrays").astype(np.int32)),
            np.ascontiguousarray(
                table("eb_dr_intra_derivative").astype(np.int32)),
            # the npz stores these bitmasks as int32 elements holding
            # byte values; the C side indexes uint8_t bytes, so cast
            *[np.ascontiguousarray(table(f"has_tr_{w}x{h}").astype(np.uint8))
              for w, h in _SIZE_PAIRS],
            *[np.ascontiguousarray(table(f"has_bl_{w}x{h}").astype(np.uint8))
              for w, h in _SIZE_PAIRS],
            tx_w, tx_h, txs, shp, ems,
        )
    return _CONSTS


def _eligible(codec, decider) -> bool:
    if getattr(codec.fh, "allow_screen_content_tools", False):
        return False          # palette blocks need the Python walk
    fh, seq = codec.fh, codec.seq
    if fh.frame_type != FrameType.KEY_FRAME:
        return False
    if not getattr(decider, "plan_replayable", False):
        return False
    if getattr(fh, "tx_mode_select", False):
        return False
    if seq.monochrome:
        return False
    if codec.num_planes != 3 or seq.bit_depth not in (8, 10):
        return False
    if codec.lr_units is not None:          # LR syntax interleaves
        return False
    if codec.mi_rows % 2 or codec.mi_cols % 2:   # 4x4 leaves unsupported
        return False
    if getattr(fh, "seg_qdeltas", ()):       # segmentation syntax off
        return False
    if fh.base_q_idx == 0:                  # lossless: different tx path
        return False
    return True


def _dry_run(codec, decider, rect):
    """Mirror FrameCodec._partition's traversal for one tile, consulting
    the decider; returns (part_seq int8, mode_seq int32[n,16]) or None
    when an unsupported shape/feature appears."""
    from ..pipeline.frame_codec import (PARTITION_NONE, PARTITION_HORZ,
                                        PARTITION_VERT, PARTITION_SPLIT,
                                        get_ext_tx_set_type, max_txsize_rect,
                                        AV1_NUM_EXT_TX_SET, AV1_EXT_TX_IND,
                                        EXT_TX_SET_INDEX, _bsize_enum)

    mi_rows, mi_cols = codec.mi_rows, codec.mi_cols
    r0, c0, r1, c1 = rect
    parts: list[int] = []
    modes: list[list[int]] = []
    reduced = codec.fh.reduced_tx_set

    # fast leaf path for map-driven deciders (BatchedIntraDecider):
    # modes come straight from the per-shape device maps; the per-size
    # invariants (tx sizes, ext-tx signaling, chroma tx-type lut) are
    # cached once per shape
    fast_modes = getattr(decider, "_modes", None)
    size_info: dict = {}

    def _info(bw, bh):
        got = size_info.get((bw, bh))
        if got is not None:
            return got
        from ..pipeline.frame_codec import BlockDecision
        ts_y = max_txsize_rect(bw, bh)
        ts_uv = max_txsize_rect(max(bw >> 1, 4), max(bh >> 1, 4))
        set_type = get_ext_tx_set_type(ts_y, False, reduced)
        nset = AV1_NUM_EXT_TX_SET[set_type]
        eset = sq = ind = 0
        if nset > 1:
            eset = EXT_TX_SET_INDEX[0][set_type]
            sq = cf._sq_idx(min(TX_WIDTH[ts_y], TX_HEIGHT[ts_y]))
            ind = AV1_EXT_TX_IND[set_type][0]      # DCT_DCT
        tt_uv = [int(codec.tx_type_for(1, BlockDecision(uv_mode=m), ts_uv))
                 for m in range(13)]
        got = (int(ts_y), int(ts_uv), nset, eset, sq, ind,
               _bsize_enum(bw, bh), tt_uv)
        size_info[(bw, bh)] = got
        return got

    def leaf_fast(bw, bh, r, c) -> bool:
        mm = fast_modes.get((bw, bh)) if fast_modes else None
        if mm is None:
            return leaf(bw, bh, r, c)
        m = int(mm[r * 4 // bh, c * 4 // bw])
        ts_y, ts_uv, nset, eset, sq, ind, bse, tt_uv = _info(bw, bh)
        modes.append([m, 0, m, 0, -1, 0, ts_y, ts_uv, 0, tt_uv[m],
                      nset, eset, sq, ind, bse, 0])
        return True

    def leaf(bw, bh, r, c) -> bool:
        if bw > 32 or bh > 32 or bw < 8 or bh < 8:
            return False
        d = decider.decide(codec, c * 4, r * 4, bw, bh)
        if d.filter_intra_mode >= 0 or d.uv_mode == 13:
            return False
        if d.segment_id != 0 or getattr(d, "tx_depth", 0) != 0:
            return False
        ts_y = max_txsize_rect(bw, bh)
        ts_uv = max_txsize_rect(max(bw >> 1, 4), max(bh >> 1, 4))
        tt_y = int(getattr(d, "tx_type_y", TxType.DCT_DCT))
        tt_uv = int(codec.tx_type_for(1, d, ts_uv))
        if cf.TX_TYPE_TO_CLASS[tt_y] != cf.TX_CLASS_2D or \
                cf.TX_TYPE_TO_CLASS[tt_uv] != cf.TX_CLASS_2D:
            return False
        set_type = get_ext_tx_set_type(ts_y, False, reduced)
        nset = AV1_NUM_EXT_TX_SET[set_type]
        eset = sq = ind = 0
        if nset > 1:
            eset = EXT_TX_SET_INDEX[0][set_type]
            sq = cf._sq_idx(min(TX_WIDTH[ts_y], TX_HEIGHT[ts_y]))
            ind = AV1_EXT_TX_IND[set_type][tt_y]
        modes.append([int(d.y_mode), d.angle_delta_y, int(d.uv_mode),
                      d.angle_delta_uv, -1, 0, int(ts_y), int(ts_uv),
                      tt_y, tt_uv, nset, eset, sq, ind,
                      _bsize_enum(bw, bh), 0])
        return True

    def walk(bsize, r, c) -> bool:
        if r >= mi_rows or c >= mi_cols:
            return True
        bs_mi = bsize // 4
        hbs = bs_mi // 2
        has_rows = r + hbs < mi_rows
        has_cols = c + hbs < mi_cols
        if bsize < 8:
            return False
        if not has_rows and not has_cols:
            part = PARTITION_SPLIT
        else:
            part = decider.partition(bsize, r, c, has_rows, has_cols)
        parts.append(part)
        half = bsize // 2
        if part == PARTITION_NONE:
            return leaf_fast(bsize, bsize, r, c)
        if part == PARTITION_SPLIT:
            return (walk(half, r, c) and walk(half, r, c + hbs)
                    and walk(half, r + hbs, c)
                    and walk(half, r + hbs, c + hbs))
        if part == PARTITION_HORZ:
            if not leaf_fast(bsize, half, r, c):
                return False
            return (not has_rows) or leaf_fast(bsize, half, r + hbs, c)
        if part == PARTITION_VERT:
            if not leaf_fast(half, bsize, r, c):
                return False
            return (not has_cols) or leaf_fast(half, bsize, r, c + hbs)
        return False                     # AB / 4-way: python path

    sb_mi = codec.seq.sb_size // 4
    for mi_row in range(r0, r1, sb_mi):
        for mi_col in range(c0, c1, sb_mi):
            if not walk(codec.seq.sb_size, mi_row, mi_col):
                return None
    return (np.array(parts, np.int8),
            np.ascontiguousarray(np.array(modes, np.int32).reshape(-1, 16)))


def _plans_tuple(codec, mode_seq):
    """Block-plan capsules for every (plane, ts, tt) the plan uses."""
    qindex = codec.fh.base_q_idx
    bd = codec.seq.bit_depth
    pqs = (codec.yq, codec.uq, codec.vq)
    need = set()
    for row in mode_seq:
        need.add((0, int(row[6]), int(row[8])))
        need.add((1, int(row[7]), int(row[9])))
        need.add((2, int(row[7]), int(row[9])))
    plans = [None] * (3 * 19 * 16)
    for plane, ts, tt in need:
        pq = pqs[plane]
        qz._PQ_REGISTRY.setdefault(id(pq), pq)
        cap = block_plan.get_plan(id(pq), qindex, ts, tt, bd)
        if cap is None:
            return None
        plans[(plane * 19 + ts) * 16 + tt] = cap
    return tuple(plans)


def _scans_tuple(mode_seq):
    scans = [None] * 19
    for row in mode_seq:
        for ts in (int(row[6]), int(row[7])):
            if scans[ts] is None:
                scans[ts] = np.ascontiguousarray(
                    cf.scan_for(ts, TxType.DCT_DCT).astype(np.int16))
    return tuple(scans)


def _rdoq_arg(codec):
    """Frame RDOQ tables + lambda for the C walkers (None = trellis
    off); same state the Python walker uses (FrameCodec._rdoq_state)."""
    if not getattr(codec, "rdoq_level", 0):
        return None
    tables, lam = codec._rdoq_state()
    return (tables.txb_skip, tables.base_eob, tables.base,
            tables.eob_extra, tables.dc_sign, tables.lps,
            tables.eob_cost, int(lam))


def _cdfs_tuple(fc):
    return (fc.partition, fc.skip, fc.kf_y_mode, fc.angle_delta, fc.uv_mode,
            fc.intra_ext_tx, fc.txb_skip,
            fc.eob_flag_16, fc.eob_flag_32, fc.eob_flag_64, fc.eob_flag_128,
            fc.eob_flag_256, fc.eob_flag_512, fc.eob_flag_1024,
            fc.eob_extra, fc.coeff_base, fc.coeff_base_eob, fc.coeff_br,
            fc.dc_sign, fc.filter_intra)


_INTERP_TAPS: dict = {}


def _interp_taps(kind: int = 0):
    """[2][16][8] kernels of one InterpFilter kind (the frame-level
    interpolation_filter): row block 0 the 8-tap table, block 1 the
    4-tap table (zero-padded) used when the filtered block dimension
    is <= 4 (av1_get_interp_filter_params_with_block_size)."""
    got = _INTERP_TAPS.get(kind)
    if got is None:
        from ..ops import inter as inter_ops
        got = np.ascontiguousarray(np.stack(
            [inter_ops.interp_kernel(kind, q4, w)
             for w in (8, 4) for q4 in range(16)]).astype(np.int32))
        _INTERP_TAPS[kind] = got
    return got


# C-side shape order (coder_native.c SHAPE_LIST); the 64-px shapes are
# inter-only (no mode map — zeros passed)
_C_SHAPES = ((8, 8), (16, 16), (32, 32), (16, 8), (8, 16), (32, 16),
             (16, 32), (64, 64), (64, 32), (32, 64))


def _sig_tables(codec):
    """Per-tx-size luma tx-type signaling constants + chroma-tt lut."""
    from ..pipeline.frame_codec import (BlockDecision, get_ext_tx_set_type,
                                        AV1_NUM_EXT_TX_SET, AV1_EXT_TX_IND,
                                        EXT_TX_SET_INDEX)
    reduced = codec.fh.reduced_tx_set
    sig_i = np.zeros((19, 4), np.int32)
    sig_n = np.zeros((19, 4), np.int32)
    tt_uv = np.zeros((19, 13), np.int32)
    for ts in range(19):
        for is_inter, arr in ((True, sig_n), (False, sig_i)):
            set_type = get_ext_tx_set_type(ts, is_inter, reduced)
            nset = AV1_NUM_EXT_TX_SET[set_type]
            if nset > 1:
                arr[ts] = (nset,
                           EXT_TX_SET_INDEX[1 if is_inter else 0][set_type],
                           cf._sq_idx(min(TX_WIDTH[ts], TX_HEIGHT[ts])),
                           AV1_EXT_TX_IND[set_type][0])
        for m in range(13):
            tt_uv[ts, m] = int(codec.tx_type_for(
                1, BlockDecision(uv_mode=m), ts))
    return sig_n, sig_i, tt_uv


def _eligible_inter(codec, decider) -> bool:
    fh, seq = codec.fh, codec.seq
    if getattr(fh, "allow_screen_content_tools", False):
        return False
    if getattr(decider, "_inter", None) is None:
        return False
    for s in _C_SHAPES:
        if s not in decider._inter:
            return False
        if max(s) <= 32 and s not in decider._modes:
            return False
    if getattr(fh, "tx_mode_select", False) or seq.monochrome:
        return False
    if codec.num_planes != 3 or seq.bit_depth not in (8, 10):
        return False
    if codec.lr_units is not None or getattr(fh, "seg_qdeltas", ()):
        return False
    if codec.mi_rows % 2 or codec.mi_cols % 2:
        return False
    if fh.base_q_idx == 0:
        return False
    if fh.is_motion_mode_switchable or fh.allow_warped_motion:
        return False
    # masked-compound / inter-intra syntax interleaves per block
    if seq.enable_masked_compound or seq.enable_interintra_compound:
        return False
    gm = getattr(fh, "global_motion", ())
    if gm and any(t for t, _ in gm):
        return False
    if codec.refs is None or 1 not in codec.refs:
        return False
    # the plan's selection fields drive the C walker (multi-ref single
    # + averaged compound); anything else needs the Python replay
    if getattr(decider, "_sf", None) is None:
        return False
    if not getattr(decider, "_names", None):
        return False
    return True


def _dry_run_partitions(codec, decider, rect):
    """Partition decisions only (the per-leaf work happens in C)."""
    from ..pipeline.frame_codec import PARTITION_NONE, PARTITION_HORZ, \
        PARTITION_VERT, PARTITION_SPLIT

    mi_rows, mi_cols = codec.mi_rows, codec.mi_cols
    parts: list[int] = []

    def walk(bsize, r, c) -> bool:
        if r >= mi_rows or c >= mi_cols:
            return True
        bs_mi = bsize // 4
        hbs = bs_mi // 2
        has_rows = r + hbs < mi_rows
        has_cols = c + hbs < mi_cols
        if bsize < 8:
            return False
        if not has_rows and not has_cols:
            part = PARTITION_SPLIT
        else:
            part = decider.partition(bsize, r, c, has_rows, has_cols)
        parts.append(part)
        half = bsize // 2
        if part == PARTITION_NONE:
            return 8 <= bsize <= 64
        if part == PARTITION_SPLIT:
            return (walk(half, r, c) and walk(half, r, c + hbs)
                    and walk(half, r + hbs, c)
                    and walk(half, r + hbs, c + hbs))
        if part in (PARTITION_HORZ, PARTITION_VERT):
            return half >= 8 and bsize <= 64
        return False

    sb_mi = codec.seq.sb_size // 4
    r0, c0, r1, c1 = rect
    for mi_row in range(r0, r1, sb_mi):
        for mi_col in range(c0, c1, sb_mi):
            if not walk(codec.seq.sb_size, mi_row, mi_col):
                return None
    return np.array(parts, np.int8)


def _inter_plans_tuple(codec):
    """Plans for every (plane, ts, tt) an inter frame can touch: DCT for
    all block tx sizes + the chroma intra tts."""
    qindex = codec.fh.base_q_idx
    bd = codec.seq.bit_depth
    pqs = (codec.yq, codec.uq, codec.vq)
    sizes_y = set()
    sizes_uv = set()
    for (w, h) in _C_SHAPES:
        for ts in range(19):
            if TX_WIDTH[ts] == w and TX_HEIGHT[ts] == h:
                sizes_y.add(ts)
            if TX_WIDTH[ts] == w >> 1 and TX_HEIGHT[ts] == h >> 1:
                sizes_uv.add(ts)
    _, _, tt_uv = _sig_tables(codec)
    need = set()
    for ts in sizes_y:
        need.add((0, ts, 0))
    for ts in sizes_uv:
        need.add((1, ts, 0))
        need.add((2, ts, 0))
        for m in range(13):
            need.add((1, ts, int(tt_uv[ts, m])))
            need.add((2, ts, int(tt_uv[ts, m])))
    plans = [None] * (3 * 19 * 16)
    for plane, ts, tt in need:
        pq = pqs[plane]
        qz._PQ_REGISTRY.setdefault(id(pq), pq)
        cap = block_plan.get_plan(id(pq), qindex, ts, tt, bd)
        if cap is None:
            return None
        plans[(plane * 19 + ts) * 16 + tt] = cap
    return tuple(plans), sorted(sizes_y | sizes_uv)


def try_encode_tiles_native_inter(codec, decider):
    """Inter-frame native path: the C walker replays the partition plan
    and makes the per-block decisions itself from the device maps
    (decide_inter port), so no per-block python runs at all."""
    if not available():
        return None
    plan_hook = getattr(decider, "plan_superblock", None)
    if plan_hook is None:
        return None
    rects = codec.tile_rects()
    codec.tile = rects[0]
    plan_hook(codec, rects[0][0], rects[0][1])
    if not _eligible_inter(codec, decider):
        return None

    consts = _consts()
    planes = tuple(np.ascontiguousarray(p, np.int32) for p in codec.source) \
        + tuple(codec.recon[:3])
    got = _inter_plans_tuple(codec)
    if got is None:
        return None
    plans, all_ts = got
    scans = [None] * 19
    for ts in all_ts:
        scans[ts] = np.ascontiguousarray(
            cf.scan_for(ts, TxType.DCT_DCT).astype(np.int16))
    scans = tuple(scans)
    sig_n, sig_i, tt_uv = _sig_tables(codec)
    g = codec.mi
    mia = tuple(np.ascontiguousarray(a, np.int32) for a in (
        g.ref_frame, g.ref_frame1, g.mode, g.mv_row, g.mv_col,
        g.mv1_row, g.mv1_col, g.bw4, g.bh4))
    # the C coder must write through to the codec's own grids
    for arr, name in zip(mia, ("ref_frame", "ref_frame1", "mode", "mv_row",
                               "mv_col", "mv1_row", "mv1_col", "bw4",
                               "bh4")):
        if arr is not getattr(g, name):
            setattr(g, name, arr)
    sgrids = tuple(codec.skip_grid[:3])
    refs = tuple((name, pl[0], pl[1], pl[2])
                 for name, pl in codec.refs.items())
    maps = []
    for s in _C_SHAPES:
        im = decider._inter[s]
        maps.append(np.ascontiguousarray(im.astype(np.uint8)))
        md = decider._modes.get(s)
        if md is None:          # inter-only 64-px shapes
            md = np.zeros(im.shape, np.int8)
        maps.append(np.ascontiguousarray(md.astype(np.int8)))
    sf = decider._sf
    mvs = tuple(np.ascontiguousarray(sf[k], np.int32)
                for k in ("mv_r", "mv_c", "sel", "fwd_i", "bwd_i",
                          "mv1_r", "mv1_c")) \
        + (np.ascontiguousarray(decider._names, np.int32),)
    sig = (np.ascontiguousarray(sig_n), np.ascontiguousarray(sig_i),
           np.ascontiguousarray(tt_uv),
           _interp_taps(getattr(codec.fh, "interpolation_filter", 0)),
           np.asarray(codec.sign_bias, np.int32))

    blobs = []
    for rect in rects:
        codec.tile = rect
        codec._reset_tile_contexts()
        part_seq = _dry_run_partitions(codec, decider, rect)
        if part_seq is None:
            return None
        fc = codec.fc
        icdfs = (fc.intra_inter, fc.single_ref, fc.newmv, fc.zeromv,
                 fc.refmv, fc.drl, fc.y_mode, fc.inter_ext_tx,
                 fc.comp_inter, fc.comp_ref_type, fc.comp_ref,
                 fc.comp_bwdref, fc.inter_compound_mode)
        nmvc = fc.nmv
        nmv = [nmvc.joints]
        for comp in nmvc.comps:
            nmv += [comp.classes, comp.class0_fp, comp.fp, comp.sign,
                    comp.class0_hp, comp.hp, comp.class0, comp.bits]
        ints = (codec.mi_rows, codec.mi_cols, rect[0], rect[1], rect[2],
                rect[3], codec.buf_w, codec.buf_h, codec.seq.sb_size,
                codec.seq.bit_depth, codec.num_planes,
                int(codec.fh.reduced_tx_set), codec.aligned_w,
                codec.aligned_h,
                int(not codec.seq.enable_intra_edge_filter),
                int(codec.seq.enable_filter_intra))
        ctxs = (codec.y_modes, codec.skips, codec.above_part,
                codec.left_part,
                codec.txb_above[0], codec.txb_above[1], codec.txb_above[2],
                codec.txb_left[0], codec.txb_left[1], codec.txb_left[2],
                codec.tx_w_grid[0], codec.tx_w_grid[1], codec.tx_w_grid[2],
                codec.tx_h_grid[0], codec.tx_h_grid[1], codec.tx_h_grid[2],
                codec.bedge_x[0], codec.bedge_x[1], codec.bedge_x[2],
                codec.bedge_y[0], codec.bedge_y[1], codec.bedge_y[2])
        from ..pipeline.frame_codec import REF_PAD
        from ..pipeline.batched_inter import SEL_MV_W, selection_pens
        pen_q8 = int(round(256.0 * float(selection_pens(
            codec.fh.base_q_idx, codec.seq.bit_depth)[3]) / SEL_MV_W))
        iints = (codec.fh.frame_width, codec.fh.frame_height,
                 REF_PAD, int(codec.fh.reference_select), pen_q8)
        blob = _cn.code_inter_tile(
            ints, planes, ctxs, _cdfs_tuple(fc), consts, scans, plans,
            part_seq, iints, mia, sgrids, refs, tuple(maps), mvs,
            icdfs, tuple(nmv), sig, _rdoq_arg(codec))
        blobs.append(blob)
    return blobs


def try_encode_tiles_native(codec, decider):
    """One-C-call-per-tile conformant encode; returns tile blobs or None
    when the frame needs the general Python walk."""
    if not available() or not _eligible(codec, decider):
        return None
    plan_hook = getattr(decider, "plan_superblock", None)
    rects = codec.tile_rects()
    if plan_hook is not None:
        codec.tile = rects[0]
        plan_hook(codec, rects[0][0], rects[0][1])

    consts = _consts()
    planes = tuple(np.ascontiguousarray(p, np.int32) for p in codec.source) \
        + tuple(codec.recon[:3])
    for p in planes:
        assert p.dtype == np.int32
    blobs = []
    for rect in rects:
        codec.tile = rect
        codec._reset_tile_contexts()
        seqs = _dry_run(codec, decider, rect)
        if seqs is None:
            return None
        part_seq, mode_seq = seqs
        plans = _plans_tuple(codec, mode_seq)
        if plans is None:
            return None
        ints = (codec.mi_rows, codec.mi_cols, rect[0], rect[1], rect[2],
                rect[3], codec.buf_w, codec.buf_h, codec.seq.sb_size,
                codec.seq.bit_depth, codec.num_planes,
                int(codec.fh.reduced_tx_set), codec.aligned_w,
                codec.aligned_h,
                int(not codec.seq.enable_intra_edge_filter),
                int(codec.seq.enable_filter_intra))
        ctxs = (codec.y_modes, codec.skips, codec.above_part,
                codec.left_part,
                codec.txb_above[0], codec.txb_above[1], codec.txb_above[2],
                codec.txb_left[0], codec.txb_left[1], codec.txb_left[2],
                codec.tx_w_grid[0], codec.tx_w_grid[1], codec.tx_w_grid[2],
                codec.tx_h_grid[0], codec.tx_h_grid[1], codec.tx_h_grid[2],
                codec.bedge_x[0], codec.bedge_x[1], codec.bedge_x[2],
                codec.bedge_y[0], codec.bedge_y[1], codec.bedge_y[2])
        blob = _cn.code_intra_tile(ints, planes, ctxs, _cdfs_tuple(codec.fc),
                                   consts, _scans_tuple(mode_seq), plans,
                                   part_seq, mode_seq, _rdoq_arg(codec))
        blobs.append(blob)
    return blobs
