"""The port's per-frame filter chain (svt_av1_tpu_torch/ops/filter_chain.py)
against the JAX package: on a frame coded by both packages' FrameCodec
from the same source, the chain's level and CDEF strengths equal a search
composed from the JAX numpy twins, and its planes equal the JAX sequential
host path (loop_filter_plane, then cdef_frame) run at them."""
import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import cdef as ref_cdef
from svt_av1_tpu.ops import dlf as ref_dlf
from svt_av1_tpu.ops.filter_chain import (PRI_SET, PRI_SET_FAST, SEC_SET,
                                          SEC_SET_FAST)
from svt_av1_tpu_torch.bitstream.headers import FrameHeader, SequenceHeader
from svt_av1_tpu_torch.constants import FrameType
from svt_av1_tpu_torch.ops.filter_chain import dlf_cdef_chain
from svt_av1_tpu_torch.pipeline.batched_md import TorchIntraDecider
from svt_av1_tpu_torch.pipeline.frame_codec import FrameCodec

from test_filter_chain import _coded_frame

W, H, QIDX = 128, 96, 80


def _port_frame(w=W, h=H, qidx=QIDX, seed=1):
    """The port's FrameCodec on the source test_filter_chain codes."""
    ref = _coded_frame(w, h, qidx, seed)
    planes = tuple(p[:(h >> (1 if i else 0)), :(w >> (1 if i else 0))]
                   .astype(np.uint8) for i, p in enumerate(ref.source))
    seq = SequenceHeader(max_frame_width=w, max_frame_height=h)
    seq.enable_restoration = False
    seq.enable_cdef = True
    fh = FrameHeader(frame_type=FrameType.KEY_FRAME, frame_width=w,
                     frame_height=h, base_q_idx=qidx,
                     filter_level=(8, 8), filter_level_uv=(8, 8))
    dev = torch.device("cpu")
    codec = FrameCodec(seq, fh, source_planes=planes, device=dev)
    codec.encode_tiles(TorchIntraDecider(dev))
    return codec, ref


def _twin_search(ref, fast):
    """Level and strengths by the chain's search rule, from the JAX numpy
    twins: luma SSE over {off, L/2, L, 3L/2}, then the (pri, sec) grid
    argmin of cdef_search_errs on the deblocked planes."""
    fh = ref.fh
    base = max(fh.filter_level)
    cands = sorted({max(base // 2, 1), max(base, 1),
                    min(3 * base // 2, ref_dlf.MAX_LOOP_FILTER)})
    vis = [((fh.frame_width + (p > 0)) >> (p > 0),
            (fh.frame_height + (p > 0)) >> (p > 0)) for p in range(3)]
    prm = [ref_dlf.edge_params(ref.tx_w_grid[p], ref.tx_h_grid[p],
                               ref.skip_grid[p], ref.bedge_x[p],
                               ref.bedge_y[p], *vis[p], p > 0)
           for p in range(3)]
    vw, vh = vis[0]
    src = ref.source[0][:vh, :vw].astype(np.int64)
    best, best_sse = 0, int(((ref.recon[0][:vh, :vw] - src) ** 2).sum())
    for lv in cands:
        fy = ref_dlf.loop_filter_plane_full(ref.recon[0], *prm[0], vw, vh,
                                            lv, lv, fh.sharpness, 8, np)
        sse = int(((fy[:vh, :vw] - src) ** 2).sum())
        if sse < best_sse:
            best, best_sse = lv, sse
    deb = [ref.recon[p] if best == 0 else ref_dlf.loop_filter_plane_full(
        ref.recon[p], *prm[p], *vis[p], best, best, fh.sharpness, 8, np)
        for p in range(3)]
    fw, fhp = ref.mi_cols * 4, ref.mi_rows * 4
    ns = ref_cdef.nonskip_grid(ref.skips, ref.mi_rows, ref.mi_cols)
    rec = [d[:fhp >> (p > 0), :fw >> (p > 0)] for p, d in enumerate(deb)]
    srcs = [s[:fhp >> (p > 0), :fw >> (p > 0)].astype(np.int32)
            for p, s in enumerate(ref.source)]
    padded = ref_cdef.pad_very_large(rec[0], fw, fhp, 8, np)
    dirs, var = ref_cdef.find_dir_grid(
        ref_cdef._units_of(padded, fw, fhp, 8, np), 0, np)
    pri_set, sec_set = (PRI_SET_FAST, SEC_SET_FAST) if fast \
        else (PRI_SET, SEC_SET)
    errs = ref_cdef.cdef_search_errs(srcs, rec, dirs, var, ns, fw, fhp,
                                     fh.cdef_damping, 8, pri_set, sec_set,
                                     np)
    strengths = []
    for e in errs:
        i = int(np.argmin(np.asarray(e)))
        strengths.append(pri_set[i // len(sec_set)] * 4
                         + sec_set[i % len(sec_set)])
    return best, tuple(strengths)


def _sequential(ref, level, ystr, uvstr):
    """The JAX sequential host path at the given level and strengths."""
    fh = ref.fh
    if level > 0:
        for p in range(3):
            sx = 1 if p else 0
            ref_dlf.loop_filter_plane(
                ref.recon[p], ref.tx_w_grid[p], ref.tx_h_grid[p],
                ref.skip_grid[p], ref.bedge_x[p], ref.bedge_y[p],
                (fh.frame_width + sx) >> sx, (fh.frame_height + sx) >> sx,
                level, level, fh.sharpness, p > 0, 8)
    return ref_cdef.cdef_frame(ref.recon, ref.skips, ref.mi_rows,
                               ref.mi_cols, ystr, uvstr, fh.cdef_damping, 8)


@pytest.mark.parametrize("fast", [False, True], ids=["full", "fast"])
def test_chain_matches_twin_search_and_sequential_path(fast):
    codec, ref = _port_frame()
    for p in range(3):
        np.testing.assert_array_equal(codec.recon[p], ref.recon[p])
    codec.cdef_fast = fast
    want_level, want_str = _twin_search(ref, fast)
    assert dlf_cdef_chain(codec)
    level = codec.fh.filter_level[0]
    got_str = (codec.fh.cdef_y_strengths[0], codec.fh.cdef_uv_strengths[0])
    assert (level, got_str) == (want_level, want_str)
    assert codec.fh.filter_level_uv == (level, level)
    assert codec.fh.dlf_level_searched
    want = _sequential(ref, level, *got_str)
    for p in range(3):
        np.testing.assert_array_equal(codec.recon[p], want[p])


def _decline_cdef_off(codec):
    codec.seq.enable_cdef = False


def _decline_level_zero(codec):
    codec.fh.filter_level = (0, 0)


def _decline_all_skip(codec):
    codec.skips[:] = 1


def _decline_searched(codec):
    codec.fh.dlf_level_searched = True


def _decline_intrabc(codec):
    codec.fh.allow_intrabc = True


def _decline_restoration(codec):
    codec.seq.enable_restoration = True


@pytest.mark.parametrize("decline", [_decline_cdef_off, _decline_level_zero,
                                     _decline_all_skip, _decline_searched,
                                     _decline_intrabc, _decline_restoration],
                         ids=["cdef_off", "level_zero", "all_skip",
                              "searched", "intrabc", "restoration"])
def test_chain_declines(decline):
    codec, _ = _port_frame(64, 64)
    before = [p.copy() for p in codec.recon]
    decline(codec)
    assert not dlf_cdef_chain(codec)
    for p in range(3):
        np.testing.assert_array_equal(codec.recon[p], before[p])


def test_frame_codec_needs_a_device():
    """No host filter path: a codec without a device is refused."""
    seq = SequenceHeader(max_frame_width=64, max_frame_height=64)
    fh = FrameHeader(frame_type=FrameType.KEY_FRAME, frame_width=64,
                     frame_height=64, base_q_idx=QIDX)
    with pytest.raises(ValueError, match="device"):
        FrameCodec(seq, fh, source_planes=None, device=None)


def test_decline_branch_runs_the_same_search():
    """After a decline at an all-skip frame the encoder runs the
    standalone level search and the strength search + apply (the JAX
    package's dlf_search_apply_device / cdef_search_apply_device); on a
    frame the chain would take, that branch gives the chain's result."""
    a, _ = _port_frame(seed=2)
    b, _ = _port_frame(seed=2)
    a.cdef_fast = b.cdef_fast = False
    assert dlf_cdef_chain(a)
    b.apply_loop_filter()
    b.search_and_apply_cdef()
    assert b.fh.filter_level == a.fh.filter_level
    assert (b.fh.cdef_y_strengths, b.fh.cdef_uv_strengths) == \
        (a.fh.cdef_y_strengths, a.fh.cdef_uv_strengths)
    for p in range(3):
        np.testing.assert_array_equal(a.recon[p], b.recon[p])
