"""Frame-batched mode decision (port of svt_av1_tpu/pipeline/batched_md.py
and of the decider of svt_av1_tpu/pipeline/batched_inter.py).

Key frames: one device pass (ops/omd.py, the K1 kernel) scores every
intra mode for every block at all candidate shapes.  Inter frames: the
inter frame program (pipeline/batched_inter.py: K5-K8 and K1) adds the
motion-compensated residual costs and the per-unit reference and MV
choice.  A tiny host DP then composes the partition tree
(NONE/HORZ/VERT/SPLIT) from the per-shape cost maps, mirroring the
semantics of FrameCodec._partition (boundary nodes forced to SPLIT).
The conformant coding pass replays the plan: decisions are open-loop
(source edges and source references), reconstruction stays exact,
matching the reference's PD0 decoupling (EbEncDecProcess.c:4534).
"""
from __future__ import annotations

import contextvars

import numpy as np

from ..constants import FrameType, PredictionMode
from ..ops import omd
from ..profiling import run_as_worker, span
from .frame_codec import (ModeDecider, BlockDecision, PARTITION_NONE,
                          PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT)


def _sym_bits(icdf: np.ndarray, sym: int) -> float:
    prev = 32768 if sym == 0 else int(icdf[sym - 1])
    p = (prev - int(icdf[sym])) / 32768.0
    return float(-np.log2(max(p, 1e-6)))


def default_mode_bits(fc) -> tuple:
    """Approximate per-mode signaling bits from the default CDFs:
    kf y-mode (neutral neighbor ctx) + the delta-0 angle symbol for
    directional modes."""
    cdf = fc.kf_y_mode[0][0]
    out = []
    for m in range(13):
        bits = _sym_bits(cdf, m)
        if PredictionMode.V_PRED <= m <= PredictionMode.D67_PRED:
            bits += _sym_bits(fc.angle_delta[m - 1], 3)
        out.append(round(bits, 3))
    return tuple(out)


def _partition_bits(fc, bsize: int) -> dict:
    bsl = (bsize // 8).bit_length() - 1
    cdf = fc.partition[bsl * 4]
    return {p: _sym_bits(cdf, p) for p in
            (PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT,
             PARTITION_SPLIT)}


def partition_dp(cost, lam: float, pbits: dict, mi_rows: int,
                 mi_cols: int, bsizes=(16, 32)) -> dict:
    """Vectorized bottom-up DP over the partition tree (the host twin
    of FrameCodec._partition's recursion).  Arithmetic mirrors the
    scalar form exactly: pair sums for HORZ/VERT stay in the cost maps'
    float32 before widening, everything else accumulates in float64.
    Returns {(bsize, mi_row, mi_col): partition}.  ``bsizes`` lists the
    decision levels bottom-up; infinite shape costs (e.g. intra-only
    regions at inter-only 64-px shapes) force SPLIT."""
    plan = {}

    def pad_to(a, hh, ww):
        out = np.zeros((hh, ww), np.float64)
        h0 = min(a.shape[0], hh)
        w0 = min(a.shape[1], ww)
        out[:h0, :w0] = a[:h0, :w0]
        return out

    # leaf level: 8x8 cost where the node origin is inside the frame
    c8 = np.asarray(cost[(8, 8)])
    h8 = -(-mi_rows // 2)
    w8 = -(-mi_cols // 2)
    best = np.zeros(c8.shape, np.float64)
    best[:h8, :w8] = c8[:h8, :w8].astype(np.float64)
    best[h8:, :] = 0.0
    best[:, w8:] = 0.0

    for bsize in bsizes:
        bs_mi = bsize // 4
        hbs = bs_mi // 2
        half = bsize // 2
        pb = pbits[bsize]
        nr = -(-mi_rows // bs_mi)      # valid node rows
        nc = -(-mi_cols // bs_mi)
        nh = best.shape[0] // 2        # node grid from child grid
        nw = best.shape[1] // 2
        chb = pad_to(best, nh * 2, nw * 2)
        s = chb[0::2, 0::2] + chb[0::2, 1::2]
        s = s + chb[1::2, 0::2]
        split_raw = s + chb[1::2, 1::2]
        none_c = pad_to(np.asarray(cost[(bsize, bsize)], np.float64),
                        nh, nw) + lam * pb[PARTITION_NONE]
        hmap = np.asarray(cost[(bsize, half)])
        hp = (hmap[0::2, :] + hmap[1::2, :])       # f32 pair sum
        horz_c = pad_to(hp.astype(np.float64), nh, nw) \
            + lam * pb[PARTITION_HORZ]
        vmap = np.asarray(cost[(half, bsize)])
        vp = (vmap[:, 0::2] + vmap[:, 1::2])
        vert_c = pad_to(vp.astype(np.float64), nh, nw) \
            + lam * pb[PARTITION_VERT]
        split_c = split_raw + lam * pb[PARTITION_SPLIT]
        stacked = np.stack([none_c, horz_c, vert_c, split_c])
        part = np.argmin(stacked, axis=0).astype(np.int8)
        bestv = np.take_along_axis(stacked, part[None].astype(np.int64),
                                   0)[0]
        # boundary nodes: forced SPLIT, children only (no bits)
        rr = np.arange(nh) * bs_mi
        cc = np.arange(nw) * bs_mi
        bound = (rr[:, None] + hbs >= mi_rows) | \
                (cc[None, :] + hbs >= mi_cols)
        part = np.where(bound, np.int8(PARTITION_SPLIT), part)
        bestv = np.where(bound, split_raw, bestv)
        # out-of-frame nodes contribute 0 to their parents
        valid = (rr[:, None] < mi_rows) & (cc[None, :] < mi_cols)
        bestv = np.where(valid, bestv, 0.0)
        for i in range(min(nr, nh)):
            base_r = i * bs_mi
            row = part[i]
            for j in range(min(nc, nw)):
                plan[(bsize, base_r, j * bs_mi)] = int(row[j])
        best = bestv
    return plan


class _MiniFuture:
    """Future for the prefetch worker (result/cancel only)."""

    def __init__(self):
        import threading

        self._ev = threading.Event()
        self._result = None
        self._exc = None

    def result(self, timeout=None):
        if not self._ev.wait(timeout):
            raise TimeoutError("prefetch result")
        if self._exc is not None:
            raise self._exc
        return self._result

    def cancel(self):
        return False            # best-effort parity with cf.Future


class _PrefetchWorker:
    """Single daemon-thread work queue (the SRM worker analog).

    concurrent.futures' ThreadPoolExecutor joins its (non-daemon)
    workers at interpreter exit, so one in-flight device compile could
    stall process shutdown by minutes (seen as the multichip dryrun
    timing out AFTER printing success); a daemon thread dies with the
    process instead."""

    def __init__(self):
        import queue
        import threading

        self._q = queue.Queue()
        threading.Thread(target=self._loop, daemon=True,
                         name="md-prefetch").start()

    def _loop(self):
        while True:
            ctx, fn, args, fut = self._q.get()
            try:
                fut._result = ctx.run(fn, *args)
            except BaseException as e:   # delivered via fut.result()
                fut._exc = e
            fut._ev.set()

    def submit(self, fn, *args):
        """Queue ``fn(*args)``; it runs in a copy of the submitter's
        context (its encoder's timer and picture, profiling.py)."""
        fut = _MiniFuture()
        self._q.put((contextvars.copy_context(), fn, args, fut))
        return fut


class TorchIntraDecider(ModeDecider):
    """Key-frame decider driven by the batched open-loop device pass on
    ``device`` (the counterpart of BatchedIntraDecider); TorchDecider
    adds the inter frames."""

    # decisions are a pure function of the precomputed plan, so the
    # native tile coder may dry-run + replay them (native/tile_coder.py)
    plan_replayable = True

    def __init__(self, device):
        super().__init__(block_size=32)
        self.device = device
        self.prof = None            # StageTimer of the owning encoder
        self._plan = None
        self._modes = None
        self._planned_for = None

    # -- pipeline overlap: the device decision pass for frame N+1 runs on
    # a worker thread while the host packs frame N (the kernel launches
    # and the device->host copies release the GIL) -----------------------

    _executor = None
    _prefetch: dict | None = None

    @staticmethod
    def _decide(source_plane, buf_w, buf_h, qindex, lam, mode_bits, bd,
                device):
        """Upload + decision; returns (maps, device luma plane)."""
        plane = omd.upload_plane(source_plane, buf_w, buf_h, bd, device)
        maps = omd.intra_decision_frame(plane, buf_w, buf_h, qindex, lam,
                                        mode_bits, bd)
        return maps, plane

    def prefetch(self, display: int, source_plane, buf_w: int, buf_h: int,
                 qindex: int, bd: int):
        from ..entropy.tables import FrameCdfs
        from .rdo import rd_lambda

        if TorchIntraDecider._executor is None:
            TorchIntraDecider._executor = _PrefetchWorker()
        if self._prefetch is None:
            self._prefetch = {}
        if display in self._prefetch \
                and self._prefetch[display][0] == qindex:
            return
        lam = rd_lambda(qindex, bd)
        mode_bits = default_mode_bits(FrameCdfs(qindex))
        fut = TorchIntraDecider._executor.submit(
            run_as_worker, "plan", self._decide, source_plane, buf_w, buf_h,
            qindex, lam, mode_bits, bd, self.device)
        self._prefetch[display] = (qindex, fut, source_plane)

    def _take_prefetched(self, codec):
        """The prefetched (maps, device luma) of the codec's frame; the
        luma is None where the frame codes another source than the one
        buffered (MCTF filtered it, super-resolution narrowed it): the
        maps stand, as in the JAX encoder, the filter searches upload the
        coded source."""
        if not self._prefetch:
            return None
        got = self._prefetch.pop(codec.fh.order_hint, None)
        if got is None:
            return None
        qindex, fut, src = got
        if qindex != codec.fh.base_q_idx:
            fut.cancel()
            return None
        with span("plan_wait"):
            maps, dev_y = fut.result()
        h, w = src.shape
        coded = codec.source[0]
        if coded.shape[1] < w or not np.array_equal(coded[:h, :w], src):
            dev_y = None
        return maps, dev_y

    def plan_superblock(self, codec, mi_row, mi_col):
        if codec.fh.frame_type != FrameType.KEY_FRAME:
            self._planned_for = None
            self._plan = None
            self._modes = None
            return
        if self._planned_for is codec:
            return
        self._planned_for = codec
        if self.prof is not None:
            with self.prof("plan"):
                self._plan_frame(codec)
        else:
            self._plan_frame(codec)

    def _plan_frame(self, codec):
        from .rdo import rd_lambda

        lam = rd_lambda(codec.fh.base_q_idx, codec.seq.bit_depth)
        mode_bits = default_mode_bits(codec.fc)
        got = self._take_prefetched(codec)
        if got is not None:
            maps, dev_y = got
        else:
            # one upload per frame, shared with the filter chain
            dev_y = codec.device_source()[0]
            maps, _ = self._decide(dev_y, codec.buf_w, codec.buf_h,
                                   codec.fh.base_q_idx, lam, mode_bits,
                                   codec.seq.bit_depth, self.device)
        if dev_y is None:
            codec.device_source()
        elif codec.dev_source is None:
            # the prefetched luma upload joins this frame's source planes
            codec.dev_source = (dev_y,) + tuple(
                omd.upload_plane(p, p.shape[1], p.shape[0],
                                 codec.seq.bit_depth, self.device)
                for p in codec.source[1:])
        self._modes = {s: m for s, (m, _) in maps.items()}
        cost = {s: c for s, (_, c) in maps.items()}
        pbits = {b: _partition_bits(codec.fc, b) for b in (8, 16, 32)}
        self._plan = partition_dp(cost, lam, pbits, codec.mi_rows,
                                  codec.mi_cols)

    # -- replay interface ----------------------------------------------

    def partition(self, bsize, mi_row, mi_col, has_rows=True, has_cols=True):
        if self._plan is not None:
            p = self._plan.get((bsize, mi_row, mi_col))
            if p is not None:
                return p
        return super().partition(bsize, mi_row, mi_col, has_rows, has_cols)

    def decide(self, codec, x, y, bw, bh) -> BlockDecision:
        if self._modes is None or (bw, bh) not in self._modes:
            return super().decide(codec, x, y, bw, bh)
        m = int(self._modes[(bw, bh)][y // bh, x // bw])
        mode = PredictionMode(m)
        d = BlockDecision(y_mode=mode)
        d.uv_mode = m if mode <= PredictionMode.PAETH_PRED else 0
        return d


class TorchDecider(TorchIntraDecider):
    """Key frames: the batched intra plan; inter frames: the batched
    intra + ME plan (pipeline/batched_inter.py) with a per-block
    intra/inter choice over up to three single references and the
    averaged compound of a forward and a backward one (the counterpart
    of BatchedDecider)."""

    def __init__(self, device):
        super().__init__(device)
        self._inter = None          # {(w,h): is_inter bool map}
        self._sf = None             # per-16 selection field maps
        self._names = None          # plan ref index -> named ref
        # buf-aligned ME planes on the device per DPB picture, in the
        # sample type of the bit depth (device.SAMPLE_DTYPES): a recon is
        # referenced by several later frames, so it is cut, converted and
        # uploaded once per coded picture (keyed by its
        # padded luma array, which the DPB entry keeps; the cache entry
        # keeps it alive too, so its id stays unique)
        self._me_plane_cache = {}

    def plan_superblock(self, codec, mi_row, mi_col):
        from ..ops import bme

        if codec.fh.frame_type == FrameType.KEY_FRAME:
            self._inter = None
            return super().plan_superblock(codec, mi_row, mi_col)
        if self._planned_for is codec:
            return
        self._planned_for = codec
        if codec.refs is None or codec.buf_h < bme.SB + 2 * (
                bme.REFINE_R + bme.MARGIN):
            self._plan = None
            self._modes = None
            self._inter = None
            return
        if self.prof is not None:
            with self.prof("plan"):
                self._plan_inter(codec)
        else:
            self._plan_inter(codec)

    def _ref_plane(self, codec, name):
        """Buf-aligned ME plane of a named ref's reconstruction on the
        device, uploaded once per coded picture in the sample type of the
        bit depth (uint8 at 8 bits, int16 holding the 10-bit samples at
        10, as the reference keeps uint16)."""
        from .frame_codec import REF_PAD

        luma = codec.refs[name][0]
        key = (id(luma), codec.buf_h, codec.buf_w)
        hit = self._me_plane_cache.get(key)
        if hit is not None and hit[0] is luma:
            return hit[1]
        ref_y = np.asarray(luma)[REF_PAD:REF_PAD + codec.buf_h,
                                 REF_PAD:REF_PAD + codec.buf_w]
        dev = omd.upload_plane(ref_y, codec.buf_w, codec.buf_h,
                               codec.seq.bit_depth, self.device)
        if len(self._me_plane_cache) > 12:
            self._me_plane_cache.pop(next(iter(self._me_plane_cache)))
        self._me_plane_cache[key] = (luma, dev)
        return dev

    @staticmethod
    def plan_names(searched, picture_of) -> list:
        """The plan's references: the first three searched names, less
        those whose picture an earlier name already brings.  A duplicate
        never wins the selection (ties go to the first candidate, and
        every reference but the first pays the SB penalty), so dropping
        it leaves the plan as it was and saves its motion search.  Under
        compound the same holds: a duplicate's score row equals its
        original's, so the first minimum over its side (fwd_i / bwd_i)
        is still the original, and the compound index moves down with
        the reference count, which the replay reads as "compound"."""
        names, seen = [], set()
        for n in searched[:3]:
            pic = picture_of(n)
            if pic not in seen:
                seen.add(pic)
                names.append(n)
        return names

    def _plan_params(self, codec):
        """(names, bwd_mask, allow_comp, rel): the plan's static shape,
        shared by the in-line path and the cross-frame prefetch."""
        names = self.plan_names(codec.search_refs(),
                                lambda n: id(codec.refs[n][0]))
        # the "backward" side of a compound pair follows the NAMED ref
        # class (BWDREF..ALTREF): compound syntax codes ref1 with the
        # comp_bwdref tree
        bwd_mask = tuple(n >= 5 for n in names)
        allow_comp = bool(codec.fh.reference_select
                          and getattr(codec, "compound_level", 1) > 0
                          and any(bwd_mask) and not all(bwd_mask))
        ref_dists = getattr(codec, "ref_dists", None)
        rel = tuple(
            (ref_dists.get(n, 1 if n >= 5 else -1) if ref_dists
             else (1 if n >= 5 else -1)) for n in names)
        return names, bwd_mask, allow_comp, rel

    # cross-frame prefetch state: {display: (key, future)} where key =
    # (qindex, names, rel, ref displays, allow_comp) must match at
    # retrieval
    _prefetch_inter: dict | None = None

    def prefetch_inter(self, display: int, src_plane, me_refs: dict,
                       names: list, rel: tuple, ref_displays: tuple,
                       qindex: int, reference_select: bool,
                       compound_level: int, buf_w: int, buf_h: int, bd: int):
        """Submit the NEXT frame's device plan while the host codes the
        current one (open-loop: ME runs on reference SOURCES, so the plan
        does not depend on the reconstruction in flight).  The caller
        predicts ``names``/``rel``; _plan_inter checks the prediction and
        plans in line on a mismatch."""
        from ..entropy.tables import FrameCdfs
        from .batched_inter import inter_maps_dispatch
        from .rdo import rd_lambda

        if TorchIntraDecider._executor is None:
            TorchIntraDecider._executor = _PrefetchWorker()
        if self._prefetch_inter is None:
            self._prefetch_inter = {}
        bwd_mask = tuple(n >= 5 for n in names)
        allow_comp = bool(reference_select and compound_level > 0
                          and any(bwd_mask) and not all(bwd_mask))
        key = (qindex, tuple(names), tuple(rel), tuple(ref_displays),
               allow_comp)
        if display in self._prefetch_inter \
                and self._prefetch_inter[display][0] == key:
            return
        lam = rd_lambda(qindex, bd)
        mode_bits = default_mode_bits(FrameCdfs(qindex))
        refs = [me_refs[n] for n in names]
        fut = TorchIntraDecider._executor.submit(
            run_as_worker, "plan", inter_maps_dispatch, src_plane, refs,
            buf_w, buf_h, qindex, lam, mode_bits, bd, self.device, bwd_mask,
            allow_comp, rel)
        self._prefetch_inter[display] = (key, fut)

    def _take_prefetched_inter(self, codec, key):
        if not self._prefetch_inter:
            return None
        got = self._prefetch_inter.pop(codec.fh.order_hint, None)
        if got is None:
            return None
        if got[0] != key:
            from ..profiling import LOG
            LOG.debug("prefetch_inter mismatch d=%d want=%s got=%s",
                      codec.fh.order_hint, key, got[0])
            got[1].cancel()
            return None
        with span("plan_wait"):
            return got[1].result()

    def _plan_inter(self, codec):
        from .batched_inter import (INTRA_IN_INTER_BITS,
                                    inter_maps_dispatch)
        from .rdo import rd_lambda

        lam = rd_lambda(codec.fh.base_q_idx, codec.seq.bit_depth)
        names, bwd_mask, allow_comp, rel = self._plan_params(codec)
        self._names = names
        me_refs = getattr(codec, "me_refs", None)
        ref_disp = getattr(codec, "me_ref_displays", None)
        key = (codec.fh.base_q_idx, tuple(names), tuple(rel),
               tuple(ref_disp[n] for n in names) if ref_disp else (),
               allow_comp)
        got = self._take_prefetched_inter(codec, key) \
            if me_refs is not None else None
        if got is None:
            from ..entropy.tables import FrameCdfs
            # the prefetch plans with qindex-default mode bits; the in-line
            # open-loop path does the same, so the stream does not depend
            # on the prefetch's timing
            mode_bits = default_mode_bits(FrameCdfs(codec.fh.base_q_idx)) \
                if me_refs is not None else default_mode_bits(codec.fc)
            if me_refs is not None:
                # open-loop: ME against the reference pictures' SOURCES
                refs = [me_refs[n] for n in names]
            else:
                refs = [self._ref_plane(codec, n) for n in names]
            # one upload per frame, shared with the filter chain
            got = inter_maps_dispatch(
                codec.device_source()[0], refs, codec.buf_w, codec.buf_h,
                codec.fh.base_q_idx, lam, mode_bits, codec.seq.bit_depth,
                self.device, bwd_mask, allow_comp, rel)
        intra, inter_cost, sf, mvb = got
        self._sf = sf

        # frame-level interpolation filter, decided before any replay MC
        codec.fh.interpolation_filter = self._select_interp_filter(
            codec, sf, names)

        # per-shape combined cost + choice: a shape is inter-eligible when
        # every 16x16 unit it covers made the SAME choice (ref + MVs -> one
        # coded block); sub-16 shapes inherit the parent unit's choice
        self._modes = {s: m for s, (m, _) in intra.items()}
        self._inter = {}
        cost = {}
        for (w, h) in omd.INTER_SHAPES:
            nc = inter_cost[(w, h)]
            if (w, h) in intra:
                ic = intra[(w, h)][1] + lam * INTRA_IN_INTER_BITS
            else:
                # 64-px shapes are inter-only (intra stays <= 32); the DP
                # splits where inter is ineligible
                ic = np.full(nc.shape, np.inf, np.float32)
            nr, ncol = ic.shape
            fy, fx = max(h // 16, 1), max(w // 16, 1)
            pr = np.arange(nr) * h // 16
            pc = np.arange(ncol) * w // 16
            ok = np.ones(ic.shape, bool)
            for k in ("sel", "fwd_i", "bwd_i", "mv_r", "mv_c", "mv1_r",
                      "mv1_c"):
                m = sf[k]
                base = m[np.ix_(pr, pc)]
                for dy in range(fy):
                    for dx in range(fx):
                        ok &= m[np.ix_(pr + dy, pc + dx)] == base
            total_inter = np.where(ok, nc + lam * mvb[np.ix_(pr, pc)],
                                   np.inf)
            use_inter = total_inter < ic
            self._inter[(w, h)] = use_inter
            cost[(w, h)] = np.where(use_inter, total_inter, ic)
        self._build_plan(codec, cost, lam)

    def _select_interp_filter(self, codec, sf, names):
        """3-way frame-level filter pick: sampled SAD of the planned
        fractional-MV units under REGULAR/SMOOTH/SHARP taps.  REGULAR
        wins ties (the ME and cost maps were modeled with it)."""
        sel, mvr, mvc = sf["sel"], sf["mv_r"], sf["mv_c"]
        frac = ((mvr % 8) != 0) | ((mvc % 8) != 0)
        # units that stay fully inside the visible frame
        nr, nc = mvr.shape
        vr = (np.arange(nr) + 1) * 16 <= codec.fh.frame_height
        vc = (np.arange(nc) + 1) * 16 <= codec.fh.frame_width
        frac &= vr[:, None] & vc[None, :]
        idx = np.argwhere(frac)
        if len(idx) < 8:
            return 0
        step = max(1, len(idx) // 96)
        idx = idx[::step][:96]
        src = codec.source[0]
        fh = codec.fh
        keep = fh.interpolation_filter
        totals = []
        for flt in (0, 1, 2):
            fh.interpolation_filter = flt
            s = 0
            for ui, uj in idx:
                y, x = int(ui) * 16, int(uj) * 16
                sv = int(sel[ui, uj])
                # a compound unit is sampled on its forward arm
                ref = names[sv] if sv < len(names) \
                    else names[int(sf["fwd_i"][ui, uj])]
                mv = (int(mvr[ui, uj]), int(mvc[ui, uj]))
                pred = codec.predict_inter(0, mv, x, y, 16, 16, ref)
                s += int(np.abs(src[y:y + 16, x:x + 16].astype(np.int32)
                                - pred).sum())
            totals.append(s)
        fh.interpolation_filter = keep
        best = int(np.argmin(totals))
        if best and totals[best] >= totals[0] * 0.998:
            return 0
        return best

    def _build_plan(self, codec, cost, lam):
        """Partition DP over the combined cost maps, up to 64x64 NONE on
        inter frames (coherent motion codes as one block)."""
        pbits = {b: _partition_bits(codec.fc, b) for b in (8, 16, 32, 64)}
        self._plan = partition_dp(cost, lam, pbits, codec.mi_rows,
                                  codec.mi_cols, bsizes=(16, 32, 64))

    # -- replay ---------------------------------------------------------

    def _decide_compound(self, codec, x, y, bw, bh, mi_row, mi_col, w4,
                         h4, u16):
        """Replay a compound-selected unit against the true compound MV
        stack (NEW_NEW vs NEAREST_NEAREST, like the per-block search);
        None when neither pair's windows stay in the frame."""
        from . import mv_pred as mp
        from .batched_inter import SEL_MV_W, selection_pens

        sf = self._sf
        rf = self._names[int(sf["fwd_i"][u16])]
        rb = self._names[int(sf["bwd_i"][u16])]
        mv0 = (int(sf["mv_r"][u16]), int(sf["mv_c"][u16]))
        mv1 = (int(sf["mv1_r"][u16]), int(sf["mv1_c"][u16]))
        stack = mp.find_mv_stack(
            codec.mi, mi_row, mi_col, w4, h4, rf,
            codec.mi_rows, codec.mi_cols, sb_mi=codec.seq.sb_size // 4,
            sign_bias=codec.sign_bias, ref_frame1=rb, tile=codec.tile,
            **codec.gm_stack_kwargs(rf, rb, mi_row, mi_col, w4, h4)).stack
        ps = float(selection_pens(codec.fh.base_q_idx,
                                  codec.seq.bit_depth)[3]) / SEL_MV_W
        trials = [(mp.NEW_NEWMV, mv0, mv1, 96 * ps)]
        if stack:
            trials.append((mp.NEAREST_NEARESTMV,
                           mp.lower_mv_precision(stack[0][0], False, False),
                           mp.lower_mv_precision(stack[0][1], False, False),
                           0))
        src_blk = codec.source[0][y:y + bh, x:x + bw].astype(np.int32)
        best = None
        for mode, m0, m1, pen in trials:
            if not (codec.mv_window_in_frame(m0, x, y, bw, bh)
                    and codec.mv_window_in_frame(m1, x, y, bw, bh)):
                continue
            pred = codec.predict_compound(0, m0, m1, x, y, bw, bh, rf, rb)
            sad = int(np.abs(src_blk - pred).sum()) + pen
            if best is None or sad < best[0]:
                best = (sad, mode, m0, m1)
        if best is None:
            return None
        _, mode, m0, m1 = best
        return BlockDecision(is_inter=True, inter_mode=mode,
                             mv=(int(m0[0]), int(m0[1])),
                             mv1=(int(m1[0]), int(m1[1])),
                             ref=rf, ref1=rb)

    def decide_inter(self, codec, x, y, bw, bh, mi_row, mi_col, w4,
                     h4=None):
        from . import mv_pred as mp
        from .batched_inter import SEL_MV_W, selection_pens

        if h4 is None:
            h4 = w4
        if self._inter is None or (bw, bh) not in self._inter:
            return super().decide_inter(codec, x, y, bw, bh, mi_row,
                                        mi_col, w4, h4)
        if not self._inter[(bw, bh)][y // bh, x // bw]:
            return self.decide(codec, x, y, bw, bh)
        sf = self._sf
        u16 = (y // 16, x // 16)
        sel = int(sf["sel"][u16])
        if sel >= len(self._names):            # compound unit
            d = self._decide_compound(codec, x, y, bw, bh, mi_row, mi_col,
                                      w4, h4, u16)
            if d is not None:
                return d
            sel = int(sf["fwd_i"][u16])        # windows failed: single
        ref = self._names[sel]
        mv = (int(sf["mv_r"][u16]), int(sf["mv_c"][u16]))
        stack_res = mp.find_mv_stack(
            codec.mi, mi_row, mi_col, w4, h4, ref,
            codec.mi_rows, codec.mi_cols, sb_mi=codec.seq.sb_size // 4,
            sign_bias=codec.sign_bias, tile=codec.tile)
        nearest = tuple(stack_res.ref_mv_list[0])
        near = tuple(stack_res.ref_mv_list[1])
        # mini candidate refinement against the true MVP stack: the device
        # plan supplies NEWMV; NEAREST/NEAR/GLOBAL often code almost free
        src_blk = codec.source[0][y:y + bh, x:x + bw].astype(np.int32)
        ps = float(selection_pens(codec.fh.base_q_idx,
                                  codec.seq.bit_depth)[3]) / SEL_MV_W
        cands = []
        if codec.mv_window_in_frame(mv, x, y, bw, bh):
            cands.append((mv, mp.NEWMV, 96 * ps))
        if codec.mv_window_in_frame(nearest, x, y, bw, bh):
            cands.append((nearest, mp.NEARESTMV, 0))
        if len(stack_res.stack) >= 2 and near != nearest \
                and codec.mv_window_in_frame(near, x, y, bw, bh):
            cands.append((near, mp.NEARMV, 16 * ps))
        if codec.mv_window_in_frame((0, 0), x, y, bw, bh):
            cands.append(((0, 0), mp.GLOBALMV, 32 * ps))
        if not cands:
            return self.decide(codec, x, y, bw, bh)
        best = None
        for cmv, cmode, pen in cands:
            pred = codec.predict_inter(0, cmv, x, y, bw, bh, ref)
            sad = int(np.abs(src_blk - pred).sum()) + pen
            if best is None or sad < best[0]:
                best = (sad, cmv, cmode)
        _, mv, mode = best
        if mode == mp.NEWMV and mv == nearest:
            mode = mp.NEARESTMV
        return BlockDecision(is_inter=True, inter_mode=mode,
                             mv=(int(mv[0]), int(mv[1])),
                             ref_mv_idx=0, ref=ref)
