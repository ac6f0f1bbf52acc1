"""Rate-distortion optimized mode decision.

The analog of the reference's MD stage ladder (EbProductCodingLoop.c
md_encode_block / md_stage_3 full-RD): candidates are evaluated with the
true coding cost — distortion from the conformant recon path and rate
measured by trial-packing the quantized coefficients with the native
range coder against snapshot CDFs.

Lambda follows the libaom convention (rd_mult ~ q_step^2); the scale was
tuned on synthetic content for same-rate PSNR.
"""
from __future__ import annotations

import numpy as np

from ..constants import PredictionMode, TxType, TX_WIDTH, TX_HEIGHT
from ..entropy import coeffs as cf
from ..entropy.tables import FrameCdfs, dc_q
from ..native import HAVE_NATIVE_EC
from ..ops import quant as qz
from ..ops import transforms as tf
from .frame_codec import (BlockDecision, FrameCodec, ModeDecider,
                          PARTITION_NONE, PARTITION_SPLIT, SymbolWriter,
                          max_txsize_rect)

ALL_Y_MODES = [PredictionMode(m) for m in range(13)]


def rd_lambda(qindex: int, bit_depth: int = 8) -> float:
    """~libaom av1_compute_rd_mult: proportional to (dc_q/4)^2."""
    q = dc_q(qindex, bit_depth) / 8.0
    return 0.85 * q * q


def sad_lambda(qindex: int, bit_depth: int = 8) -> float:
    """SAD-domain rate multiplier (av1_get_sad_per_bit semantics:
    proportional to dc_q, the sqrt of the SSE-domain rd_lambda)."""
    return dc_q(qindex, bit_depth) / 8.0


def _symbol_cost_bits(icdf: np.ndarray, sym: int, nsyms: int) -> float:
    prev = 32768 if sym == 0 else int(icdf[sym - 1])
    p = (prev - int(icdf[sym])) / 32768.0
    return -np.log2(max(p, 1e-6))


class _RateProbe:
    """Measures true coefficient rate by trial-packing with the native
    coder against throwaway CDF copies."""

    def __init__(self, fc: FrameCdfs):
        self.fc = fc

    def coeff_bits(self, qcoeff, tx_size, tx_type, plane_type,
                   txb_skip_ctx, dc_sign_ctx, eob) -> float:
        from ..entropy.native_ec import NativeRangeEncoder

        enc = NativeRangeEncoder()
        snap = _SnapshotCdfs(self.fc)
        enc.write_coeffs_fast(snap, qcoeff, tx_size, tx_type, plane_type,
                              txb_skip_ctx, dc_sign_ctx, eob)
        return float(enc.tell_bits())


class _SnapshotCdfs:
    """Copy-on-read view of the coefficient CDFs (trials must not mutate
    the real frame contexts).  ``deep=True`` also clones non-array slots
    (the NMV context object) so full-block trial coding can adapt them."""

    def __init__(self, fc: FrameCdfs, deep: bool = False):
        self._fc = fc
        self._deep = deep
        self._cache = {}

    def __getattr__(self, name):
        fc = object.__getattribute__(self, "_fc")
        cache = object.__getattribute__(self, "_cache")
        if name not in cache:
            v = getattr(fc, name)
            if isinstance(v, np.ndarray):
                v = v.copy()
            elif object.__getattribute__(self, "_deep"):
                import copy as _copy
                v = _copy.deepcopy(v)
            cache[name] = v
        return cache[name]

    def eob_flag(self, k):
        return getattr(self, f"eob_flag_{1 << k}")


class RdoDecider(ModeDecider):
    """Full-RD intra mode decision (fixed square partition for now)."""

    def __init__(self, block_size: int = 32, modes=None,
                 uv_modes=(0, 1, 2, 9, 12), try_angle_delta: bool = False,
                 n_full_rd: int = 4, n_full_rd_uv: int = 2,
                 try_cfl: bool = True):
        super().__init__(block_size, modes or ALL_Y_MODES)
        self.uv_modes = uv_modes
        self.try_angle_delta = try_angle_delta
        self.n_full_rd = n_full_rd
        self.n_full_rd_uv = n_full_rd_uv
        self.try_cfl = try_cfl

    def _stage0_prune(self, codec, plane, modes, x, y, bw, bh, ts, keep):
        """Cheap funnel: prediction SAD ranks candidates (the analog of
        md_stage_0's fast cost)."""
        sx = 1 if plane else 0
        px, py = x >> sx, y >> sx
        pw, ph = bw >> sx, bh >> sx
        src = codec.source[plane][py:py + ph, px:px + pw].astype(np.int32)
        scored = []
        for m in modes:
            pred = codec.predict(plane, PredictionMode(m), 0, px, py, pw, ph, ts)
            scored.append((int(np.abs(src - pred).sum()), m))
        scored.sort()
        return [m for _, m in scored[:keep]]

    def decide(self, codec: FrameCodec, x, y, bw, bh) -> BlockDecision:
        if not HAVE_NATIVE_EC:
            return super().decide(codec, x, y, bw, bh)
        seg = codec.aq_seg(x, y)
        lam = rd_lambda(codec.seg_qidx(seg), codec.seq.bit_depth)
        probe = _RateProbe(codec.fc)
        mi_row, mi_col = y // 4, x // 4

        # luma: SAD funnel then full RD on the survivors
        best = None
        ts = codec.tx_size_for(0, bw, bh)
        survivors = self._stage0_prune(codec, 0, self.modes, x, y, bw, bh,
                                       ts, self.n_full_rd)
        cand_modes = [(m, 0) for m in survivors]
        for mode, delta in cand_modes:
            cost, info = self._block_cost(codec, probe, 0, mode, delta,
                                          x, y, bw, bh, ts, lam,
                                          mi_row, mi_col)
            if best is None or cost < best[0]:
                best = (cost, mode, delta)
        if self.try_angle_delta and best[1] >= PredictionMode.V_PRED \
                and best[1] <= PredictionMode.D67_PRED and bw >= 8:
            for delta in (-2, -1, 1, 2):
                cost, _ = self._block_cost(codec, probe, 0, best[1], delta,
                                           x, y, bw, bh, ts, lam,
                                           mi_row, mi_col)
                if cost < best[0]:
                    best = (cost, best[1], delta)
        y_mode, angle_y = best[1], best[2]

        # chroma: RD over a small uv set + chroma-from-luma
        uv_ts = codec.tx_size_for(1, bw, bh)
        uv_cands = set(self._stage0_prune(codec, 1, self.uv_modes, x, y,
                                          bw, bh, uv_ts, self.n_full_rd_uv))
        uv_cands |= {int(y_mode)} if int(y_mode) in self.uv_modes else {0}
        best_uv = None
        for uv in sorted(uv_cands):
            total = 0.0
            for plane in (1, 2):
                c, _ = self._block_cost(
                    codec, probe, plane, PredictionMode(uv), 0,
                    x, y, bw, bh, uv_ts, lam, mi_row, mi_col,
                    uv_mode_for_txtype=uv)
                total += c
            if best_uv is None or total < best_uv[0]:
                best_uv = (total, uv)

        # filter-intra: SAD-rank the 5 recursive modes, full-RD the top
        # one against the best conventional mode (FilterIntra appendix)
        fi_mode = -1
        if (codec.seq.enable_filter_intra and bw <= 32 and bh <= 32):
            sx = codec.source[0][y:y + bh, x:x + bw].astype(np.int32)
            ranked = []
            for m in range(5):
                pred = codec.predict(0, PredictionMode.DC_PRED, 0, x, y,
                                     bw, bh, ts, filter_intra_mode=m)
                ranked.append((int(np.abs(sx - pred).sum()), m))
            ranked.sort()
            m = ranked[0][1]
            pred = codec.predict(0, PredictionMode.DC_PRED, 0, x, y,
                                 bw, bh, ts, filter_intra_mode=m)
            cost, _ = self._block_cost(codec, probe, 0, PredictionMode
                                       .DC_PRED, 0, x, y, bw, bh, ts,
                                       lam, mi_row, mi_col,
                                       explicit_pred=pred)
            # flag + ~2.3 bits of fi mode
            if cost + lam * 3.3 < best[0]:
                best = (cost, PredictionMode.DC_PRED, 0)
                y_mode, angle_y = PredictionMode.DC_PRED, 0
                fi_mode = m

        # luma tx depth (TX_MODE_SELECT): largest vs one split, true cost
        tx_depth = 0
        if codec.fh.tx_mode_select and not (bw == 4 and bh == 4):
            from .frame_codec import bsize_max_tx_depth, bsize_tx_size_cat
            mdep = bsize_max_tx_depth(bw, bh)
            if mdep >= 1:
                d0 = self._luma_depth_cost(codec, probe, y_mode, angle_y,
                                           fi_mode, x, y, bw, bh, 0, lam)
                d1 = self._luma_depth_cost(codec, probe, y_mode, angle_y,
                                           fi_mode, x, y, bw, bh, 1, lam)
                cdf = codec.fc.tx_size[bsize_tx_size_cat(bw, bh)][
                    codec._tx_size_ctx(mi_row, mi_col, bw, bh)]
                c0 = _symbol_cost_bits(cdf, 0, mdep + 1)
                c1 = _symbol_cost_bits(cdf, 1, mdep + 1)
                if d1 + lam * c1 < d0 + lam * c0:
                    tx_depth = 1

        cfl = None
        if self.try_cfl and bw <= 32 and bh <= 32:
            cfl = self._try_cfl(codec, probe, x, y, bw, bh, uv_ts, lam,
                                y_mode, angle_y, best_uv[0],
                                fi_mode=fi_mode)
        if cfl is not None:
            return BlockDecision(y_mode=y_mode, angle_delta_y=angle_y,
                                 uv_mode=13, cfl_signs=cfl[0],
                                 cfl_idx=cfl[1],
                                 filter_intra_mode=fi_mode,
                                 tx_depth=tx_depth, segment_id=seg)
        return BlockDecision(y_mode=y_mode, angle_delta_y=angle_y,
                             uv_mode=best_uv[1], angle_delta_uv=0,
                             filter_intra_mode=fi_mode,
                             tx_depth=tx_depth, segment_id=seg)

    def _luma_depth_cost(self, codec, probe, mode, delta, fi, x, y,
                         bw, bh, depth, lam):
        """True luma coding cost at a given tx split depth: each sub tx
        block predicted from the running recon (restored afterwards)."""
        from .frame_codec import depth_to_tx_size
        ts = depth_to_tx_size(depth, bw, bh)
        tw, th = TX_WIDTH[ts], TX_HEIGHT[ts]
        saved = codec.recon[0][y:y + bh, x:x + bw].copy()
        dist = 0.0
        bits = 0.0
        beq = bw == tw and bh == th
        try:
            for py in range(y, y + bh, th):
                for px in range(x, x + bw, tw):
                    pred = codec.predict(0, mode, delta, px, py, tw, th,
                                         ts, filter_intra_mode=fi,
                                         blk=(x, y, bw, bh))
                    src = codec.source[0][py:py + th, px:px + tw]
                    resid = src.astype(np.int32) - pred
                    coeffs = np.asarray(tf.fwd_txfm2d(
                        resid, TxType.DCT_DCT, ts, codec.seq.bit_depth))
                    qc, dqc = qz.quantize_b(coeffs, codec.fh.base_q_idx,
                                            codec._plane_quant(0), ts)
                    qc = np.asarray(qc)
                    ch, cw = min(th, 32), min(tw, 32)
                    eob = cf.compute_eob(qc[:ch, :cw], ts, TxType.DCT_DCT)
                    recon = np.asarray(tf.inv_txfm2d_add(
                        np.asarray(dqc) if eob else np.zeros_like(dqc),
                        pred, TxType.DCT_DCT, ts, codec.seq.bit_depth))
                    codec.recon[0][py:py + th, px:px + tw] = recon
                    dist += float(((recon - src.astype(np.int64)) ** 2).sum())
                    sk_ctx, dc_ctx = codec._txb_ctx(0, px, py, tw, th, ts,
                                                    beq)
                    bits += probe.coeff_bits(qc[:ch, :cw], ts,
                                             TxType.DCT_DCT, 0, sk_ctx,
                                             dc_ctx, eob)
        finally:
            codec.recon[0][y:y + bh, x:x + bw] = saved
        return dist + lam * bits

    def _try_cfl(self, codec, probe, x, y, bw, bh, uv_ts, lam,
                 y_mode, angle_y, best_cost, fi_mode=-1):
        """Chroma-from-luma candidate: reconstruct luma with the chosen
        mode, least-SSE alpha per plane, full-RD compare vs the best
        conventional uv mode."""
        from ..ops import intra as intra_ops

        ts = codec.tx_size_for(0, bw, bh)
        pred = codec.predict(0, y_mode, angle_y, x, y, bw, bh, ts,
                             filter_intra_mode=fi_mode)
        src = codec.source[0][y:y + bh, x:x + bw]
        resid = src.astype(np.int32) - pred
        coeffs = np.asarray(tf.fwd_txfm2d(resid, TxType.DCT_DCT, ts,
                                          codec.seq.bit_depth))
        _, dqc = qz.quantize_b(coeffs, codec.fh.base_q_idx,
                               codec._plane_quant(0), ts)
        luma_rec = np.asarray(tf.inv_txfm2d_add(
            np.asarray(dqc), pred, TxType.DCT_DCT, ts, codec.seq.bit_depth))
        ac = intra_ops.cfl_ac(intra_ops.cfl_luma_q3(luma_rec))

        alphas = []
        for plane in (1, 2):
            px, py = x >> 1, y >> 1
            pw, ph = bw >> 1, bh >> 1
            dc = codec.predict(plane, PredictionMode.DC_PRED, 0,
                               px, py, pw, ph, uv_ts)
            tgt = codec.source[plane][py:py + ph, px:px + pw].astype(
                np.int64) - dc
            best = (1 << 62, 0)
            for a in range(-16, 17):
                v = a * ac
                scaled = np.where(v >= 0, (v + 32) >> 6, -((-v + 32) >> 6))
                sse = int(((tgt - scaled) ** 2).sum())
                if sse < best[0]:
                    best = (sse, a)
            alphas.append(best[1])
        au, av = alphas
        if au == 0 and av == 0:
            return None
        sign = lambda a: 0 if a == 0 else (2 if a > 0 else 1)
        joint = sign(au) * 3 + sign(av) - 1
        idx = ((abs(au) - 1 if au else 0) << 4) | (abs(av) - 1 if av else 0)
        d = BlockDecision(y_mode=y_mode, angle_delta_y=angle_y, uv_mode=13,
                          cfl_signs=joint, cfl_idx=idx)
        total = 0.0
        for plane in (1, 2):
            px, py = x >> 1, y >> 1
            pw, ph = bw >> 1, bh >> 1
            pred_c = codec.predict_chroma_with_luma(plane, d, px, py,
                                                    pw, ph, uv_ts, luma_rec)
            c, _ = self._block_cost(codec, probe, plane, None, 0, x, y,
                                    bw, bh, uv_ts, lam, 0, 0,
                                    uv_mode_for_txtype=0,
                                    explicit_pred=pred_c)
            total += c
        # ~12 bits of cfl side info
        if total + lam * 12 < best_cost:
            return joint, idx
        return None

    def _block_cost(self, codec: FrameCodec, probe, plane, mode, delta,
                    x, y, bw, bh, ts, lam, mi_row, mi_col,
                    uv_mode_for_txtype=None, explicit_pred=None):
        sx = 1 if plane else 0
        px, py = x >> sx, y >> sx
        pw, ph = bw >> sx, bh >> sx
        if plane == 0:
            tt = TxType.DCT_DCT
        else:
            d = BlockDecision(uv_mode=uv_mode_for_txtype or 0)
            tt = codec.tx_type_for(plane, d, ts)
        if explicit_pred is not None:
            pred = explicit_pred
        else:
            pred = codec.predict(plane, mode, delta, px, py, pw, ph, ts)
        src = codec.source[plane][py:py + ph, px:px + pw]
        resid = src.astype(np.int32) - pred
        coeffs = np.asarray(tf.fwd_txfm2d(resid, tt, ts, codec.seq.bit_depth))
        qc, dqc = qz.quantize_b(coeffs, codec.fh.base_q_idx,
                                codec._plane_quant(plane), ts)
        qc = np.asarray(qc)
        ch, cw = min(TX_HEIGHT[ts], 32), min(TX_WIDTH[ts], 32)
        eob = cf.compute_eob(qc[:ch, :cw], ts, tt)
        recon = np.asarray(tf.inv_txfm2d_add(
            np.asarray(dqc) if eob else np.zeros_like(dqc), pred, tt, ts,
            codec.seq.bit_depth))
        dist = float(((recon - src.astype(np.int64)) ** 2).sum())
        bsize_eq_tx = pw == TX_WIDTH[ts] and ph == TX_HEIGHT[ts]
        sk_ctx, dc_ctx = codec._txb_ctx(plane, px, py, pw, ph, ts, bsize_eq_tx)
        bits = probe.coeff_bits(qc[:ch, :cw], ts, tt, int(plane > 0),
                                sk_ctx, dc_ctx, eob)
        # mode signaling bits
        if plane == 0:
            up = int(codec.y_modes[mi_row - 1, mi_col]) if mi_row > 0 else 0
            lf = int(codec.y_modes[mi_row, mi_col - 1]) if mi_col > 0 else 0
            from .frame_codec import INTRA_MODE_CONTEXT
            kf_cdf = codec.fc.kf_y_mode[INTRA_MODE_CONTEXT[up]][INTRA_MODE_CONTEXT[lf]]
            bits += _symbol_cost_bits(kf_cdf, int(mode), 13)
        else:
            pass  # uv mode bits shared across both chroma planes; omitted
        return dist + lam * bits, (qc, eob)


# --------------------------------------------------------------------------
# Variable block-size RD partitioning
# --------------------------------------------------------------------------

class _RegionState:
    """Snapshot/restore of every codec context a block region touches,
    so partition trials can be rolled back (the analog of the reference
    MD's candidate-buffer neighbor arrays, EbModeDecisionProcess)."""

    _MI_FIELDS = ("ref_frame", "mv_row", "mv_col", "mode", "bw4", "bh4",
                  "ref_frame1", "mv1_row", "mv1_col")

    def __init__(self, codec: FrameCodec, mi_row: int, mi_col: int,
                 bs_mi: int):
        x, y = mi_col * 4, mi_row * 4
        r1 = min(mi_row + bs_mi, codec.mi_rows)
        c1 = min(mi_col + bs_mi, codec.mi_cols)
        items = self.items = []

        def grab(arr, sl):
            items.append((arr, sl, arr[sl].copy()))

        for p in range(codec.num_planes):
            sh = 1 if p else 0
            px, py = x >> sh, y >> sh
            pw = ph = (bs_mi * 4) >> sh
            grab(codec.recon[p], np.s_[py:py + ph, px:px + pw])
            x4, y4, w4, h4 = px >> 2, py >> 2, pw >> 2, ph >> 2
            grab(codec.txb_above[p], np.s_[x4:x4 + w4])
            grab(codec.txb_left[p], np.s_[y4:y4 + h4])
            for g in (codec.tx_w_grid, codec.tx_h_grid, codec.bedge_x,
                      codec.bedge_y, codec.skip_grid):
                grab(g[p], np.s_[y4:y4 + h4, x4:x4 + w4])
        for arr in (codec.y_modes, codec.skips):
            grab(arr, np.s_[mi_row:r1, mi_col:c1])
        for f in self._MI_FIELDS:
            grab(getattr(codec.mi, f), np.s_[mi_row:r1, mi_col:c1])
        grab(codec.above_part, np.s_[mi_col:mi_col + bs_mi])
        grab(codec.left_part, np.s_[mi_row:mi_row + bs_mi])
        grab(codec.txfm_above, np.s_[mi_col:mi_col + bs_mi])
        grab(codec.txfm_left, np.s_[mi_row:mi_row + bs_mi])

    def restore(self, codec: FrameCodec) -> None:
        for arr, sl, data in self.items:
            arr[sl] = data


class PartitionRdoDecider(RdoDecider):
    """Recursive NONE-vs-SPLIT partition search by true RD cost.

    The analog of the reference MD's depth search (EbProductCodingLoop.c
    md_encode_block over the block tree + inter-depth cost comparison in
    EbEncDecProcess.c).  Per superblock, every legal node is trial-coded
    with a throwaway range coder against snapshot CDFs: cost = SSE of the
    conformant recon + lambda * exact bits (partition + modes + coeffs).
    The winning tree is stored in a plan the coding pass replays; all
    trial state (recon, neighbor contexts, mi grid) is rolled back.
    """

    def __init__(self, min_rd_bsize: int = 16, max_rd_bsize: int = 32,
                 ext_shapes: bool = True, **kw):
        kw.setdefault("block_size", max_rd_bsize)
        super().__init__(**kw)
        self.min_rd_bsize = min_rd_bsize
        self.max_rd_bsize = max_rd_bsize
        self.ext_shapes = ext_shapes
        self._plan = {}
        self._cache = None

    # -- plumbing the coding pass reads -------------------------------

    def partition(self, bsize, mi_row, mi_col, has_rows=True, has_cols=True):
        p = self._plan.get((bsize, mi_row, mi_col))
        if p is not None:
            return p
        return super().partition(bsize, mi_row, mi_col, has_rows, has_cols)

    def decide(self, codec, x, y, bw, bh):
        key = ("intra", x, y, bw, bh)
        if self._cache is not None and key in self._cache:
            return self._cache[key]
        d = super().decide(codec, x, y, bw, bh)
        if self._cache is not None:
            self._cache[key] = d
        return d

    def decide_inter(self, codec, x, y, bw, bh, mi_row, mi_col, w4,
                     h4=None):
        key = ("inter", x, y, bw, bh)
        if self._cache is not None and key in self._cache:
            return self._cache[key]
        d = super().decide_inter(codec, x, y, bw, bh, mi_row, mi_col,
                                 w4, h4)
        if self._cache is not None:
            self._cache[key] = d
        return d

    # -- the search ----------------------------------------------------

    replay_store = None        # set per frame by the orchestrator

    def plan_superblock(self, codec: FrameCodec, mi_row: int, mi_col: int):
        if not HAVE_NATIVE_EC:
            return
        key = (mi_row, mi_col)
        if self.replay_store is not None and key in self.replay_store:
            self._plan, self._cache = self.replay_store[key]
            return
        self._plan = {}
        self._cache = {}
        lam = rd_lambda(codec.fh.base_q_idx, codec.seq.bit_depth)
        sb_mi = codec.seq.sb_size // 4
        snap = _RegionState(codec, mi_row, mi_col, sb_mi)
        self._eval_node(codec, codec.seq.sb_size, mi_row, mi_col, lam)
        snap.restore(codec)
        if self.replay_store is not None:
            self.replay_store[key] = (self._plan, self._cache)

    def _eval_node(self, codec, bsize, r, c, lam) -> float:
        if r >= codec.mi_rows or c >= codec.mi_cols:
            return 0.0
        bs_mi = bsize // 4
        hbs = bs_mi // 2
        boundary = not (r + hbs < codec.mi_rows and c + hbs < codec.mi_cols)
        key = (bsize, r, c)

        if bsize < 8:
            return self._trial_cost(codec, bsize, r, c, lam)

        def eval_children():
            half = bsize // 2
            total = 0.0
            for rr, cc in ((r, c), (r, c + hbs), (r + hbs, c),
                           (r + hbs, c + hbs)):
                total += self._eval_node(codec, half, rr, cc, lam)
            return total

        # forced splits: node overhangs the frame (our codec only emits
        # NONE/SPLIT, so boundaries split) or exceeds the RD ceiling
        if boundary or bsize > self.max_rd_bsize:
            self._plan[key] = PARTITION_SPLIT
            return eval_children()

        if bsize <= self.min_rd_bsize:
            self._plan[key] = PARTITION_NONE
            return self._trial_cost(codec, bsize, r, c, lam)

        # choice node: SPLIT symbol rate measured before children adapt
        # the partition neighbor contexts
        split_bits = self._split_bits(codec, bsize, r, c)
        snap0 = _RegionState(codec, r, c, bs_mi)
        self._plan[key] = PARTITION_NONE
        cost_none, dist_none = self._trial_cost(
            codec, bsize, r, c, lam, with_dist=True)
        # early exit: effectively lossless at this size -> never split
        if dist_none <= lam:
            return cost_none
        best = (cost_none, PARTITION_NONE, _RegionState(codec, r, c, bs_mi))
        snap0.restore(codec)

        # rectangular + AB + 4-way partitions (>=16 keeps sub-8x8 chroma
        # out of play; 4-way strips need >=32 for the same reason)
        if bsize >= 16:
            from .frame_codec import (PARTITION_HORZ, PARTITION_VERT,
                                      PARTITION_HORZ_A, PARTITION_HORZ_B,
                                      PARTITION_VERT_A, PARTITION_VERT_B,
                                      PARTITION_HORZ_4, PARTITION_VERT_4)
            parts = [PARTITION_HORZ, PARTITION_VERT]
            if self.ext_shapes:
                parts += [PARTITION_HORZ_A, PARTITION_HORZ_B,
                          PARTITION_VERT_A, PARTITION_VERT_B]
                if bsize >= 32:
                    parts += [PARTITION_HORZ_4, PARTITION_VERT_4]
            for part in parts:
                self._plan[key] = part
                cost = self._trial_cost(codec, bsize, r, c, lam)
                if cost < best[0]:
                    best = (cost, part, _RegionState(codec, r, c, bs_mi))
                snap0.restore(codec)

        self._plan[key] = PARTITION_SPLIT
        cost_split = lam * split_bits + eval_children()

        if best[0] <= cost_split:
            self._plan[key] = best[1]
            best[2].restore(codec)
            return best[0]
        return cost_split

    def _trial_cost(self, codec, bsize, r, c, lam, with_dist=False):
        bits = self._trial_code(codec, bsize, r, c)
        dist = self._region_sse(codec, r, c, bsize // 4)
        cost = dist + lam * bits
        return (cost, dist) if with_dist else cost

    def _trial_code(self, codec, bsize, r, c) -> float:
        """Code the subtree with a throwaway writer + cloned CDFs; leaves
        recon/contexts updated (callers snapshot/restore around this)."""
        real_io, real_fc = codec.io, codec.fc
        codec.io = SymbolWriter()
        codec.fc = _SnapshotCdfs(real_fc, deep=True)
        try:
            codec._partition(bsize, r, c)
            return float(codec.io.ec.tell_bits())
        finally:
            codec.io, codec.fc = real_io, real_fc

    @staticmethod
    def _region_sse(codec, r, c, bs_mi) -> float:
        total = 0.0
        for p in range(codec.num_planes):
            sh = 1 if p else 0
            px, py = (c * 4) >> sh, (r * 4) >> sh
            pw = ph = (bs_mi * 4) >> sh
            d = codec.recon[p][py:py + ph, px:px + pw].astype(np.int64) \
                - codec.source[p][py:py + ph, px:px + pw]
            total += float((d * d).sum())
        return total

    @staticmethod
    def _split_bits(codec, bsize, r, c) -> float:
        bsl = (bsize // 8).bit_length() - 1
        above = (int(codec.above_part[c]) >> bsl) & 1
        left = (int(codec.left_part[r]) >> bsl) & 1
        ctx = (left * 2 + above) + bsl * 4
        n = 4 if bsize == 8 else (8 if bsize == 128 else 10)
        return _symbol_cost_bits(codec.fc.partition[ctx], PARTITION_SPLIT, n)
