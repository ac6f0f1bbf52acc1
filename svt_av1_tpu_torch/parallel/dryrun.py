"""``dryrun_stripes``: the stripe step on a real coded frame's state, held
against the whole frame's run of the same kernels (port of
``__graft_entry__.py:dryrun_multichip``).

1. ``capture_inter_frame`` encodes two frames of a moving synthetic
   picture with the port's ``Encoder`` (preset 8, qp 40, one key frame
   then a P frame, 64x64 superblocks so the buffer is the frame) and
   keeps the P frame's source, reference, pre-filter recon, qindex and
   the deblocking / CDEF metadata right after its tile coding.
2. ``build_stripes`` cuts them into 64-row stripes with the edge maps of
   each stripe's extended rows.
3. ``stripe_step`` runs (``parallel/stripes.py``), and ``whole_frame``
   runs the same kernels on the whole frame: ``inter_frame_maps``, the
   deblocking level search, the CDEF search and apply.
4. ``compare`` asserts the selection fields (MVs included), deblocking
   level, CDEF strength and the CDEF plane equal, the intra modes equal
   on more than 97% of every shape's blocks and the intra / inter costs
   within rtol 2e-4, atol 2 on more than 99% (the JAX dryrun's gates),
   and reports the measured shares; it also holds two runs of the step
   against each other (the kernels' and the plain versions').
5. ``gop_half``: 8 frames of 128x64 coded as one stream and as two closed
   GOPs (keyint 4) decode, with the port's ``Decoder``, to identical
   pictures.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import cdef, dlf, omd
from . import stripes as st

ROWS = 64
QP = 40
DLF_BASE = 12
PRI_SET = (0, 1, 2, 4, 6, 8, 12, 15)
SEC_SET = (0, 1, 2, 3)
DAMPING = 3


def _check(ok, what):
    """A gate of the dryrun: raises AssertionError (kept under -O)."""
    if not ok:
        raise AssertionError(what)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dlf_candidates():
    """The level search's candidates around the base level 12."""
    return tuple(sorted({max(DLF_BASE // 2, 1), DLF_BASE,
                         min(3 * DLF_BASE // 2, dlf.MAX_LOOP_FILTER)}))


def moving_pair(width: int, height: int, seed: int = 0):
    """Two luma frames of a smooth textured picture, the second moved by
    (6, -9) pixels, with flat chroma."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    f0 = (110 + 60 * np.sin(xx / 17) + 45 * np.cos(yy / 23)
          + rng.integers(-3, 4, (height, width))).clip(0, 255) \
        .astype(np.uint8)
    f1 = np.roll(f0, (6, -9), (0, 1)).copy()
    uv = np.full((height // 2, width // 2), 128, np.uint8)
    return (f0, uv, uv), (f1, uv, uv)


def capture_inter_frame(n: int, width: int, device) -> dict:
    """Encode two frames of ``moving_pair(width, 64 * n)`` on ``device``
    and return the P frame's state right after its tile coding (numpy
    arrays; ``tx_w`` .. ``bey`` are the luma deblocking grids)."""
    from ..api import Encoder
    from ..config import EncoderConfig
    from ..constants import FrameType
    from ..pipeline.frame_codec import REF_PAD, FrameCodec

    height = ROWS * n
    cap = {}
    orig = FrameCodec.encode_tiles

    def capture(codec, decider):
        blobs = orig(codec, decider)
        if codec.fh.frame_type != FrameType.KEY_FRAME and "src" not in cap:
            ref = np.asarray(codec.refs[1][0])
            cap.update(
                src=np.asarray(codec.source[0]).astype(np.uint8),
                ref=ref[REF_PAD:REF_PAD + codec.buf_h,
                        REF_PAD:REF_PAD + codec.buf_w].astype(np.uint8),
                recon=codec.recon[0].astype(np.int32),
                qindex=int(codec.fh.base_q_idx),
                tx_w=codec.tx_w_grid[0].copy(),
                tx_h=codec.tx_h_grid[0].copy(),
                skip_g=codec.skip_grid[0].copy(),
                bex=codec.bedge_x[0].copy(), bey=codec.bedge_y[0].copy(),
                skips=codec.skips.copy())
        return blobs

    FrameCodec.encode_tiles = capture
    try:
        cfg = EncoderConfig(source_width=width, source_height=height,
                            qp=QP, enc_mode=8, intra_period_length=-1,
                            hierarchical_levels=0, super_block_size=64)
        enc = Encoder(cfg, device=device)
        for planes in moving_pair(width, height):
            enc.send_picture(planes)
        enc.flush()
    finally:
        FrameCodec.encode_tiles = orig
    if "src" not in cap:
        raise RuntimeError("the capture missed the inter frame")
    if cap["src"].shape != (height, width):
        raise RuntimeError("the coded buffer is not the frame")
    return cap


def frame_params(cap: dict, device) -> st.StripeFrame:
    from ..entropy.tables import FrameCdfs
    from ..pipeline.batched_md import default_mode_bits
    from ..pipeline.rdo import rd_lambda

    q = cap["qindex"]
    return st.StripeFrame(
        ref=torch.from_numpy(cap["ref"]).to(device), qindex=q,
        lam=rd_lambda(q, 8), mode_bits=default_mode_bits(FrameCdfs(q)),
        dlf_levels=dlf_candidates(), pri_set=PRI_SET, sec_set=SEC_SET,
        damping=DAMPING)


def _edge_maps(cap: dict):
    height, width = cap["src"].shape
    return dlf.edge_params(cap["tx_w"], cap["tx_h"], cap["skip_g"],
                           cap["bex"], cap["bey"], width, height, False)


def build_stripes(cap: dict, n: int, device, indices=None) -> list:
    """The stripes ``indices`` (default all ``n``) of the captured frame
    on ``device``.  Each stripe's edge maps are the rows of the frame's
    maps under its extended rows, zero past the frame's ends (no edge in
    a filled halo); the horizontal maps lose their last row (the edge at
    the extended stripe's bottom is outside it)."""
    av, fv, ah, fh_e = _edge_maps(cap)
    hb4 = st.HB >> 2
    ext4 = (ROWS + 2 * st.HB) >> 2
    pads = [np.pad(av, ((hb4, hb4), (0, 0))),
            np.pad(fv, ((hb4, hb4), (0, 0))),
            np.pad(ah, ((hb4, hb4 + 1), (0, 0))),
            np.pad(fh_e, ((hb4, hb4 + 1), (0, 0)))]
    height, width = cap["src"].shape
    nonskip = cdef.nonskip_grid(cap["skips"], height // 4, width // 4)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    out = []
    for i in (range(n) if indices is None else indices):
        r0, u0 = i * ROWS, i * (ROWS >> 2)
        e = [p[u0:u0 + ext4] for p in pads]
        out.append(st.Stripe(
            index=i, src=t(cap["src"][r0:r0 + ROWS]),
            recon=t(cap["recon"][r0:r0 + ROWS], np.int32),
            av=t(e[0], np.uint8), fv=t(e[1], np.uint8),
            ah=t(e[2][:ext4 - 1], np.uint8), fh=t(e[3][:ext4 - 1], np.uint8),
            nonskip=t(nonskip[i * (ROWS // 8):(i + 1) * (ROWS // 8)])))
    return out


def whole_frame(cap: dict, frame: st.StripeFrame, device) -> dict:
    """The same kernels on the whole frame: the inter and intra maps
    (``inter_frame_maps`` at row 0), the deblocking level search (exact
    luma SSE of no filter and each candidate), the CDEF direction,
    strength search and apply."""
    from ..pipeline import batched_inter as bi

    height, width = cap["src"].shape
    src = torch.from_numpy(cap["src"]).to(device)
    recon = torch.from_numpy(cap["recon"]).to(device)
    intra, inter_cost, fields, mvb = bi.inter_frame_maps(
        src, [frame.ref], frame.qindex, frame.lam, frame.mode_bits, frame.bd)
    intra = omd.unpack_decisions(intra, omd.ALL_SHAPES, width, height)
    masks = [torch.from_numpy(np.ascontiguousarray(m, np.uint8)).to(device)
             for m in _edge_maps(cap)]
    s64 = src.to(torch.int64)
    planes = [recon] + [dlf.deblock(recon, *masks, width, height, lv, lv,
                                    frame.sharpness, frame.bd)
                        for lv in frame.dlf_levels]
    sse = torch.stack([((p.to(torch.int64) - s64) ** 2).sum()
                       for p in planes])
    best = st.first_min(sse)
    level = 0 if best == 0 else frame.dlf_levels[best - 1]
    dlf1 = planes[best]
    ns = torch.from_numpy(cdef.nonskip_grid(cap["skips"], height // 4,
                                            width // 4)).to(device)
    dirs, var = cdef.cdef_direction(dlf1, width, height, 0)
    err, _ = cdef.cdef_search([src], [dlf1], dirs, var, ns, width, height,
                              frame.damping, frame.bd, frame.pri_set,
                              frame.sec_set)
    ystr = cdef.pick_strength(err, frame.pri_set, frame.sec_set)
    out = cdef.cdef_apply([dlf1], ns, dirs, var, ystr, 0, frame.damping,
                          width, height, frame.bd)[0]
    return dict(intra=intra, inter_cost=inter_cost, fields=fields,
                mvbits=mvb, dlf_sse=sse, level=level, cdef_err=err,
                ystr=ystr, cdef=out)


def whole_rows(whole: dict, i: int) -> dict:
    """Stripe ``i``'s rows of the whole frame's outputs, in the form of a
    stripe's output."""
    r0 = i * ROWS
    u0 = r0 // 16

    def rows(a, h):
        return a[r0 // h:(r0 + ROWS) // h]

    return dict(
        level=whole["level"], ystr=whole["ystr"], dlf_sse=whole["dlf_sse"],
        cdef_err=whole["cdef_err"], cdef=rows(whole["cdef"], 1),
        fields={k: rows(v, 16) for k, v in whole["fields"].items()},
        mvbits=rows(whole["mvbits"], 16),
        intra={(w, h): (rows(m, h), rows(c, h))
               for (w, h), (m, c) in whole["intra"].items()},
        inter_cost={(w, h): rows(c, h)
                    for (w, h), c in whole["inter_cost"].items()})


def compare(outs: list, refs: list, indices, modes: float = 0.97,
            intra_tol=(2e-4, 2.0), costs: float = 0.99):
    """Hold each stripe's outputs against ``refs``, the same stripes of
    another run (``whole_rows`` for the whole frame's).  Deblocking level,
    CDEF strength, the SSE and error totals, the CDEF plane and every
    selection field must be equal; the intra modes equal on more than
    ``modes`` of every shape's blocks, the intra costs within ``intra_tol``
    (rtol, atol) and the inter costs within rtol 2e-4, atol 2 on more
    than ``costs``.  Returns the measured agreements (the least over
    stripes and shapes) and the largest |difference| of the float
    outputs (costs and MV bits); raises AssertionError past a gate."""
    rep = dict(intra_modes=1.0, intra_costs=1.0, inter_costs=1.0)
    err = 0.0
    rtol, atol = intra_tol
    for i, o, r in zip(indices, outs, refs):
        for k in ("level", "ystr"):
            _check(o[k] == r[k], f"stripe {i}: {k} {o[k]} != {r[k]}")
        for k in ("dlf_sse", "cdef_err", "cdef"):
            _check(torch.equal(o[k].cpu(), r[k].cpu()),
                   f"stripe {i}: {k} differs")
        for k, v in o["fields"].items():
            _check(torch.equal(v, r["fields"][k]), f"stripe {i}: {k} differs")
        err = max(err, (o["mvbits"] - r["mvbits"]).abs().max().item())
        for sh, (m, c) in o["intra"].items():
            m1, c1 = r["intra"][sh]
            rep["intra_modes"] = min(rep["intra_modes"],
                                     (m == m1).float().mean().item())
            rep["intra_costs"] = min(rep["intra_costs"], torch.isclose(
                c, c1, rtol=rtol, atol=atol).float().mean().item())
            err = max(err, (c - c1).abs().max().item())
        for sh, c in o["inter_cost"].items():
            c1 = r["inter_cost"][sh]
            rep["inter_costs"] = min(rep["inter_costs"], torch.isclose(
                c, c1, rtol=2e-4, atol=2.0).float().mean().item())
            err = max(err, (c - c1).abs().max().item())
    _check(rep["intra_modes"] > modes, f"intra modes: {rep}")
    _check(rep["intra_costs"] > costs and rep["inter_costs"] > costs,
           f"costs: {rep}")
    return rep, err


def margins(whole: dict) -> dict:
    """How far the winner of each search lies below the next larger
    total, relative to the winner (exact ties between candidates whose
    outputs are equal stay ties in any summation order).  A float32 sum
    of k terms (the JAX searches) is off by at most about k * 2^-24 of
    its value, so a margin above that cannot flip the argmin."""
    def margin(v):
        vals = sorted(set(v.reshape(-1).tolist()))
        return (vals[1] - vals[0]) / max(vals[0], 1) if len(vals) > 1 \
            else float("inf")

    return dict(dlf=margin(whole["dlf_sse"]), cdef=margin(whole["cdef_err"]))


def gop_half(device) -> dict:
    """8 frames of 128x64 (keyint 4, hierarchical_levels 2) coded as one
    stream and as two closed GOPs of 4: decoded with the port's Decoder,
    both give identical pictures, and the whole stream decodes to its
    encoder's recon."""
    from ..api import Decoder, Encoder
    from ..config import EncoderConfig

    w, h, n, keyint = 128, 64, 8, 4
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:h, 0:w]
    uv = np.full((h // 2, w // 2), 128, np.uint8)
    frames = [((120 + 60 * np.sin((xx - 3 * i) / 13)
                + 40 * np.cos((yy + 2 * i) / 11)
                + rng.integers(-4, 5, (h, w))).clip(0, 255).astype(np.uint8),
               uv, uv) for i in range(n)]

    def encode(part):
        enc = Encoder(EncoderConfig(source_width=w, source_height=h, qp=QP,
                                    enc_mode=8,
                                    intra_period_length=keyint - 1,
                                    hierarchical_levels=2), device=device)
        pkts = []
        for f in part:
            pkts += enc.send_picture(f)
        return pkts + enc.flush(), enc

    def decode(pkts):
        dec = Decoder(device)
        got = [dec.decode_frame(p) for p in pkts]
        return [g for g in got if g is not None]

    pkts, enc = encode(frames)
    whole = decode(pkts)
    parts = decode(encode(frames[:keyint])[0]) \
        + decode(encode(frames[keyint:])[0])
    _check(len(whole) == len(parts) == n,
           f"{len(whole)} and {len(parts)} pictures decoded, not {n}")
    for i, (a, b) in enumerate(zip(whole, parts)):
        for p in range(3):
            _check(np.array_equal(a[p], b[p]),
                   f"GOP-split recon differs at frame {i} plane {p}")
            _check(np.array_equal(a[p], enc.recon_by_display[i][p]),
                   f"decoded frame {i} plane {p} differs from the recon")
    return dict(frames=n, gops=2, packets=len(pkts))


def dryrun_stripes(n: int, width: int = 1280, device=None, comm=None):
    """Run the stripe step on a coded frame of ``width`` x 64n on
    ``device`` (CUDA unless asked otherwise) with ``comm`` (default
    ``LocalStripes(n)``: all stripes here), hold every output against
    the whole frame's run, and run the GOP half where stripe 0 lives
    (n >= 2).  Returns a report: the agreements, the step's and the
    whole frame's wall ms after a synchronize, the searches' winner
    margins, and the inputs and outputs (``state``, the captured frame;
    ``frame``, ``stripes``, ``outs``, ``whole``) for further checks."""
    device = resolve_device(device)
    comm = st.LocalStripes(n) if comm is None else comm
    if comm.n != n:
        raise ValueError(f"comm spans {comm.n} stripes, not {n}")
    cap = capture_inter_frame(n, width, device)
    frame = frame_params(cap, device)
    stripes = build_stripes(cap, n, device, comm.indices)
    _sync(device)
    t0 = time.perf_counter()
    outs = st.stripe_step(frame, stripes, comm)
    _sync(device)
    t1 = time.perf_counter()
    whole = whole_frame(cap, frame, device)
    _sync(device)
    t2 = time.perf_counter()
    agreement, err = compare(outs, [whole_rows(whole, i)
                                    for i in comm.indices], comm.indices)
    rep = dict(n=n, width=width, height=ROWS * n, qindex=frame.qindex,
               level=whole["level"], ystr=whole["ystr"],
               step_ms=(t1 - t0) * 1e3, whole_ms=(t2 - t1) * 1e3,
               agreement=agreement, max_abs_err=err,
               margins=margins(whole), state=cap, frame=frame,
               stripes=stripes, outs=outs, whole=whole)
    if n >= 2 and 0 in comm.indices:
        rep["gop"] = gop_half(device)
    return rep
