"""Frame-batched mode decision for key frames (port of
svt_av1_tpu/pipeline/batched_md.py).

One device pass (ops/omd.py, the K1 kernel) scores every intra mode for every block at
all candidate shapes; a tiny host DP then composes the partition tree
(NONE/HORZ/VERT/SPLIT) from the per-shape cost maps, mirroring the
semantics of FrameCodec._partition (boundary nodes forced to SPLIT).
The conformant coding pass replays the plan — decisions are open-loop
(source edges), reconstruction stays exact, matching the reference's
PD0 decoupling (EbEncDecProcess.c:4534, design doc :732-734).
"""
from __future__ import annotations

import numpy as np

from ..constants import FrameType, PredictionMode
from ..ops import omd
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
            fn, args, fut = self._q.get()
            try:
                fut._result = fn(*args)
            except BaseException as e:   # delivered via fut.result()
                fut._exc = e
            fut._ev.set()

    def submit(self, fn, *args):
        fut = _MiniFuture()
        self._q.put((fn, args, fut))
        return fut


class TorchIntraDecider(ModeDecider):
    """Key-frame decider driven by the batched open-loop device pass on
    ``device`` (the counterpart of BatchedIntraDecider).  Only key frames
    are planned: the encoder raises for configurations with other frame
    types."""

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
            self._decide, source_plane, buf_w, buf_h, qindex, lam,
            mode_bits, bd, self.device)
        self._prefetch[display] = (qindex, fut)

    def _take_prefetched(self, codec):
        if not self._prefetch:
            return None
        got = self._prefetch.pop(codec.fh.order_hint, None)
        if got is None:
            return None
        qindex, fut = got
        if qindex != codec.fh.base_q_idx:
            fut.cancel()
            return None
        return fut.result()

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
        if codec.dev_source is None:
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
