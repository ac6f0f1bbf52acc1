"""The stripe step: one inter frame's device programs on SB-row stripes
(port of the ``shard_step`` of ``__graft_entry__.py:dryrun_multichip``).

Each stripe holds ``rows`` lines of the frame (a multiple of 64) and runs,
in the order of the JAX step:

1. the batched inter decision against the whole reference (replicated):
   K5 coarse search, K6 refinement, K7 quarter-pel refinement, all at
   the stripe's global row ``row0``, then K8's selection and residual
   cost maps, which read the stripe alone;
2. the intra decision maps of the 7 shapes (K1 in stripe mode), with
   the true row above the stripe and ``HALO`` rows below it from its
   neighbours;
3. the deblocking level search: K2 on the stripe extended by ``HB`` rows
   of its neighbours' pre-filter recon each way, at the candidate
   levels, the luma SSEs summed over all stripes (exact int64), the
   first minimum taken by every stripe alike;
4. CDEF: K3's directions of the stripe, K4's strength search with the
   neighbours' 2 deblocked rows in place of CDEF_VERY_LARGE, the errors
   summed over all stripes, and K4's apply of the winner.

The JAX step's three ``ppermute``s and two ``psum``s are the calls
``from_above``, ``from_below`` and ``sum`` of a ``comm`` object:
``LocalStripes`` (every stripe in this process, on one device) or
``DistStripes`` (one stripe per rank of ``torch.distributed``: ``send``
/ ``recv`` and ``all_reduce``, gloo on the CPU or NCCL across cards).
The step works on the list of stripes this process owns, so every
exchange is one collective call.  The first and last stripes of the
frame fill their missing neighbours locally, as the JAX step's
``where(idx == 0 / n - 1, ...)`` does.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops import bme, cdef, dlf, omd
from ..pipeline import batched_inter as bi

HALO = 32           # source rows below a stripe that the intra maps read
HB = 16             # deblocking reach across a stripe edge
CDEF_ROWS = 2       # CDEF tap reach across a stripe edge
ME_SHAPES = ((16, 16), (64, 64))


@dataclasses.dataclass
class StripeFrame:
    """What every stripe of one frame shares: the whole reference luma
    (uint8 [H, W], on the stripes' device), the frame's coding
    parameters and the filter searches' candidate sets."""
    ref: torch.Tensor
    qindex: int
    lam: float
    mode_bits: tuple
    dlf_levels: tuple
    pri_set: tuple
    sec_set: tuple
    sharpness: int = 0
    damping: int = 3
    coarse_r: int = bme.COARSE_R
    bd: int = 8


@dataclasses.dataclass
class Stripe:
    """One stripe's own inputs: global index, source luma (uint8 [rows,
    W]), pre-filter recon luma (int32 [rows, W]), the deblocking edge
    maps of its extended rows (``dlf.edge_params`` of rows row0 - HB to
    row0 + rows + HB: apply/size [ext4, W/4 - 1] vertical, [ext4 - 1,
    W/4] horizontal) and the CDEF non-skip map (bool [rows/8, W/8])."""
    index: int
    src: torch.Tensor
    recon: torch.Tensor
    av: torch.Tensor
    fv: torch.Tensor
    ah: torch.Tensor
    fh: torch.Tensor
    nonskip: torch.Tensor


# the kernels' wrappers, and their plain versions on any device (for
# holding the kernels' step against on the card)
KERNELS = dict(coarse=bme.me_coarse, refine=bme.me_refine,
               subpel=bme.subpel_refine16, select=bi.inter_select,
               intra=omd.intra_decision, deblock=dlf.deblock,
               direction=cdef.cdef_direction, search=cdef.cdef_search,
               apply=cdef.cdef_apply)
PLAIN = dict(coarse=bme.coarse_sb_search, refine=bme.refine_plain,
             subpel=bme.subpel_plain, select=bi.inter_select_plain,
             intra=omd.intra_decision_plain,
             deblock=dlf.loop_filter_plane_full,
             direction=cdef.direction_plain, search=cdef.search_plain,
             apply=cdef.cdef_apply_plain)


class LocalStripes:
    """All ``n`` stripes of the frame in this process, on one device: a
    neighbour's rows are its tensor, and sums run in stripe order."""

    def __init__(self, n: int):
        self.n = n
        self.indices = list(range(n))

    def from_above(self, ts):
        """Per stripe, the tensor its upper neighbour passed (None for
        the frame's first stripe)."""
        return [None] + list(ts[:-1])

    def from_below(self, ts):
        """Per stripe, the tensor its lower neighbour passed (None for
        the frame's last stripe)."""
        return list(ts[1:]) + [None]

    def sum(self, ts):
        """Per stripe, the sum of every stripe's tensor."""
        tot = ts[0].clone()
        for t in ts[1:]:
            tot += t
        return [tot] * len(ts)


class DistStripes:
    """One stripe per rank of the default ``torch.distributed`` group
    (rank i holds stripe i of ``n`` = the world size): neighbour rows
    travel by ``batch_isend_irecv``, sums by ``all_reduce``.  The tensors
    live where the backend takes them (CPU for gloo, the rank's card for
    NCCL)."""

    def __init__(self):
        import torch.distributed as dist

        self.dist = dist
        self.rank = dist.get_rank()
        self.n = dist.get_world_size()
        self.indices = [self.rank]

    def _shift(self, t, src, dst):
        dist = self.dist
        ops, got = [], None
        t = t.contiguous()
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, t, dst))
        if src is not None:
            got = torch.empty_like(t)
            ops.append(dist.P2POp(dist.irecv, got, src))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return got

    def from_above(self, ts):
        r = self.rank
        return [self._shift(ts[0], r - 1 if r > 0 else None,
                            r + 1 if r < self.n - 1 else None)]

    def from_below(self, ts):
        r = self.rank
        return [self._shift(ts[0], r + 1 if r < self.n - 1 else None,
                            r - 1 if r > 0 else None)]

    def sum(self, ts):
        tot = ts[0].clone()
        self.dist.all_reduce(tot)
        return [tot]


def first_min(values) -> int:
    """Index of the first minimum of a small tensor (read on the host)."""
    vals = values.tolist()
    return vals.index(min(vals))


def _inter(ops, frame: StripeFrame, s: Stripe, row0: int):
    """The inter decision of one stripe: (fields, mvbits16, cost maps)."""
    ref = frame.ref
    coarse = ops["coarse"](s.src, ref, frame.coarse_r, row0)
    me = ops["refine"](s.src, ref, coarse, ME_SHAPES, row0)
    n_sby, n_sbx = me["grid"]
    mv_r16 = bi._nested_to_grid(me[(16, 16)][0], n_sby, n_sbx, 4, 4)
    mv_c16 = bi._nested_to_grid(me[(16, 16)][1], n_sby, n_sbx, 4, 4)
    mvq_r, mvq_c, pred = ops["subpel"](s.src, ref, mv_r16, mv_c16, frame.bd,
                                       row0)
    sb_r = me[(64, 64)][0].reshape(1, n_sby, n_sbx).contiguous()
    sb_c = me[(64, 64)][1].reshape(1, n_sby, n_sbx).contiguous()
    return ops["select"](s.src, pred[None], mvq_r[None], mvq_c[None], sb_r,
                         sb_c, frame.qindex, frame.lam, frame.bd)


def stripe_step(frame: StripeFrame, stripes, comm, plain: bool = False):
    """Run the step on the stripes this process owns (``comm.indices``,
    in that order).  Returns per stripe a dict: ``intra`` {(w, h): (mode,
    cost)}, ``inter_cost`` {(w, h): cost}, ``fields`` (K8's selection
    fields, MVs in eighth-pel), ``mvbits``, ``dlf_sse`` (the summed luma
    SSE of no filter and each candidate level, int64), ``level``,
    ``cdef_err`` (the summed [pri, sec] errors, int64), ``ystr`` (coded
    pri * 4 + sec) and ``cdef`` (the stripe's deblocked and CDEF-filtered
    luma, int32 [rows, W]).  ``plain`` runs the kernels' plain versions
    on the stripes' device instead of the kernels (such a run is not
    counted in ``stripe_step.launches``)."""
    ops = PLAIN if plain else KERNELS
    rows, W = stripes[0].src.shape
    last = comm.n - 1
    out = [dict() for _ in stripes]

    # 1. the batched inter decision
    for o, s in zip(out, stripes):
        fields, mvb, cost = _inter(ops, frame, s, s.index * rows)
        o.update(fields=fields, mvbits=mvb, inter_cost=cost)

    # 2. the intra maps between the true neighbour rows
    above = comm.from_above([s.src[-1] for s in stripes])
    below = comm.from_below([s.src[:HALO] for s in stripes])
    for o, s, a, b in zip(out, stripes, above, below):
        a = s.src[0] if s.index == 0 else a
        b = s.src[-1:].expand(HALO, W).contiguous() if s.index == last \
            else b
        o["intra"] = {(w, h): ops["intra"](s.src, w, h, frame.qindex,
                                           frame.lam, frame.mode_bits,
                                           frame.bd, a, b)
                      for (w, h) in omd.ALL_SHAPES}

    # 3. deblocking: the level search over the extended stripes
    tops = comm.from_above([s.recon[-HB:] for s in stripes])
    bots = comm.from_below([s.recon[:HB] for s in stripes])
    filtered, sses = [], []
    for s, top, bot in zip(stripes, tops, bots):
        if s.index == 0:
            top = s.recon[:1].expand(HB, W)
        if s.index == last:
            bot = s.recon[-1:].expand(HB, W)
        ext = torch.cat([top, s.recon, bot]).contiguous()
        src = s.src.to(torch.int64)
        planes = [s.recon]
        for lv in frame.dlf_levels:
            planes.append(ops["deblock"](ext, s.av, s.fv, s.ah, s.fh, W,
                                         rows + 2 * HB, lv, lv,
                                         frame.sharpness, frame.bd)
                          [HB:HB + rows])
        sses.append(torch.stack([((p.to(torch.int64) - src) ** 2).sum()
                                 for p in planes]))
        filtered.append(planes)
    sse_all = comm.sum(sses)
    dlf_out = []
    for o, planes, tot in zip(out, filtered, sse_all):
        best = first_min(tot)
        o.update(dlf_sse=tot,
                 level=0 if best == 0 else frame.dlf_levels[best - 1])
        dlf_out.append(planes[best].contiguous())

    # 4. CDEF: direction, strength search over all stripes, apply
    ups = comm.from_above([d[-CDEF_ROWS:] for d in dlf_out])
    dns = comm.from_below([d[:CDEF_ROWS] for d in dlf_out])
    halos = [[(u, d)] for u, d in zip(ups, dns)]
    dirs, errs = [], []
    for s, d, h in zip(stripes, dlf_out, halos):
        dv = ops["direction"](d, W, rows, 0)
        dirs.append(dv)
        errs.append(ops["search"]([s.src], [d], *dv, s.nonskip, W, rows,
                                  frame.damping, frame.bd, frame.pri_set,
                                  frame.sec_set, h)[0])
    err_all = comm.sum(errs)
    for o, s, d, dv, h, tot in zip(out, stripes, dlf_out, dirs, halos,
                                   err_all):
        ystr = cdef.pick_strength(tot, frame.pri_set, frame.sec_set)
        o.update(cdef_err=tot, ystr=ystr,
                 cdef=ops["apply"]([d], s.nonskip, *dv, ystr, 0,
                                   frame.damping, W, rows, frame.bd, h)[0])
    if not plain:
        stripe_step.launches += 1
        stripe_step.calls += 1
    return out


stripe_step.launches = stripe_step.calls = 0
