"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small and ragged shapes (visible sizes that are no multiple of
the unit sizes), and the slices' streams (all-intra, low-delay P and
random access) coded on the card against the plain versions on the
CPU.  Needs a GPU;
run it there with

    python -m pytest -m cuda --noconftest tests/test_torch_kernels_cuda.py

(--noconftest: the suite's conftest imports jax, which the port does
not need)
"""
import numpy as np
import pytest
import torch

from svt_av1_tpu_torch.api import encode_ivf
from svt_av1_tpu_torch.config import EncoderConfig, PredStructure
from svt_av1_tpu_torch.ops import bme, cdef, dlf, omd
from svt_av1_tpu_torch.pipeline import batched_inter as bi
from svt_av1_tpu_torch.pipeline import tpl

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plane(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return (120 + 80 * np.sin(xx / 11) + 40 * np.cos(yy / 7)
            + rng.integers(-12, 13, (h, w))).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("qindex", [20, 160, 255])
def test_intra_decision_matches_plain(dev, qindex):
    plane = torch.from_numpy(_plane(192, 256, qindex)).to(dev)
    mb = tuple(np.linspace(1.0, 6.0, 13).tolist())
    before = omd.intra_decision_packed.launches
    for (w, h) in omd.ALL_SHAPES:
        m, c = omd.intra_decision(plane, w, h, qindex, 250.0, mb)
        m2, c2 = omd.intra_decision_plain(plane, w, h, qindex, 250.0, mb)
        assert (m == m2).float().mean().item() >= 0.99, (w, h)
        assert torch.isclose(c, c2, rtol=1e-5).float().mean().item() >= 0.99
    assert omd.intra_decision_packed.launches == before + len(omd.ALL_SHAPES)


def _edge_inputs(h, w, vw, vh, chroma, seed):
    rng = np.random.default_rng(seed)
    y4, x4 = h // 4, w // 4
    tx = rng.choice([4, 8, 16, 32], size=(y4, x4)).astype(np.int32)
    skip = rng.random((y4, x4)) < 0.3
    bex, bey = rng.random((y4, x4)) < 0.5, rng.random((y4, x4)) < 0.5
    return dlf.edge_params(tx, tx, skip, bex, bey, vw, vh, chroma)


@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("level", [1, 8, 32, 63])
@pytest.mark.parametrize("sharpness", [0, 3])
def test_deblock_matches_plain(dev, chroma, level, sharpness):
    h, w, vw, vh = 96, 128, 121, 90
    prm = [torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev)
           for a in _edge_inputs(h, w, vw, vh, chroma, level)]
    p = torch.from_numpy(_plane(h, w, 1).astype(np.int32)).to(dev)
    got = dlf.deblock(p, *prm, vw, vh, level, level, sharpness)
    want = dlf.loop_filter_plane_full(p, *prm, vw, vh, level, level,
                                      sharpness)
    assert torch.equal(got, want)
    if level >= 8:
        assert not torch.equal(got, p)


@pytest.mark.parametrize("size", [(128, 96), (120, 88)])
def test_cdef_kernels_match_plain(dev, size):
    fw, fh = size
    rng = np.random.default_rng(fw)
    rec = [torch.from_numpy(_plane(96 >> s, 128 >> s, s).astype(np.int32))
           .to(dev) for s in (0, 1, 1)]
    src = [(r + torch.randint(-5, 6, r.shape, device=dev)).clamp(0, 255)
           .to(torch.uint8) for r in rec]
    d1, v1 = cdef.cdef_direction(rec[0], fw, fh)
    d2, v2 = cdef.find_dir_grid(cdef._units_of(
        cdef.pad_very_large(rec[0], fw, fh, 8), fw, fh, 8), 0)
    assert torch.equal(d1, d2) and torch.equal(v1, v2)
    ns = torch.from_numpy(rng.random(d1.shape) < 0.7).to(dev)
    for ps, ss in ((cdef.PRI_SET_FAST, cdef.SEC_SET_FAST),
                   (cdef.PRI_SET, cdef.SEC_SET)):
        got = cdef.cdef_search(src, rec, d1, v1, ns, fw, fh, 4, 8, ps, ss)
        want = cdef.cdef_search_errs(src, rec, d1, v1, ns, fw, fh, 4, 8, ps,
                                     ss)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for ys, us in ((9, 6), (63, 0), (0, 61), (14, 15)):
        got = cdef.cdef_apply(rec, ns, d1, v1, ys, us, 5, fw, fh, 8)
        want = cdef.cdef_apply_plain(rec, ns, d1, v1, ys, us, 5, fw, fh, 8)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (ys, us)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError):
        omd.intra_decision(torch.zeros((64, 64), dtype=torch.int32,
                                       device=dev), 8, 8, 100, 1.0,
                           (0.0,) * 13)
    with pytest.raises(ValueError):
        cdef.cdef_direction(torch.zeros((64, 64), dtype=torch.uint8,
                                        device=dev), 64, 64)


def test_stream_on_the_card_equals_the_plain_stream(dev, tmp_path):
    rng = np.random.default_rng(5)
    frames = [(_plane(144, 176, i),
               rng.integers(100, 140, (72, 88)).astype(np.uint8),
               rng.integers(110, 150, (72, 88)).astype(np.uint8))
              for i in range(2)]
    cfg = EncoderConfig(source_width=176, source_height=144, qp=40,
                        enc_mode=8, intra_period_length=0,
                        pred_structure=PredStructure.LOW_DELAY_P)
    out = {}
    for d in ("cuda", "cpu"):
        p = tmp_path / f"{d}.ivf"
        encode_ivf(frames, cfg, str(p), device=d)
        out[d] = p.read_bytes()
    assert out["cuda"] == out["cpu"]


def _moving_pair(h, w, seed):
    """(src, ref) uint8 planes: the source is the reference moved by a
    fractional amount (the average of two shifts) plus noise."""
    rng = np.random.default_rng(seed)
    ref = _plane(h, w, seed)
    a = np.roll(ref, (3, -5), axis=(0, 1)).astype(np.int32)
    b = np.roll(ref, (4, -5), axis=(0, 1)).astype(np.int32)
    src = ((a + b + 1) // 2 + rng.integers(-2, 3, (h, w))).clip(0, 255)
    return src.astype(np.uint8), ref


@pytest.mark.parametrize("r", [8, 12, 24])
def test_me_coarse_matches_plain(dev, r):
    src, ref = (torch.from_numpy(p).to(dev) for p in _moving_pair(192, 256,
                                                                  r))
    before = (bme.me_coarse.calls, bme.me_coarse.launches)
    got = bme.me_coarse(src, ref, r)
    assert torch.equal(got, bme.coarse_sb_search(src, ref, r))
    # one wrapper call, one launch (decimation and search together)
    assert (bme.me_coarse.calls, bme.me_coarse.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("shapes", [bme.ME_SHAPES, ((16, 16), (64, 64))],
                         ids=["all", "path"])
def test_me_refine_matches_plain(dev, shapes):
    src, ref = (torch.from_numpy(p).to(dev) for p in _moving_pair(192, 256,
                                                                  7))
    coarse = bme.me_coarse(src, ref, 8)
    got = bme.me_refine(src, ref, coarse, shapes)
    want = bme.refine_plain(src, ref, coarse, shapes)
    for s in shapes:
        for g, w in zip(got[s], want[s]):
            assert torch.equal(g, w), s
    assert torch.equal(got["win16"], want["win16"])


def test_subpel_matches_plain(dev):
    src, ref = (torch.from_numpy(p).to(dev) for p in _moving_pair(192, 256,
                                                                  3))
    rng = np.random.default_rng(0)
    # MVs reaching past every edge, as well as the ME's own
    me = bme.frame_me(src, ref, 8, ((16, 16),))
    mv_r = bi._nested_to_grid(me[(16, 16)][0], 3, 4, 4, 4)
    mv_c = bi._nested_to_grid(me[(16, 16)][1], 3, 4, 4, 4)
    wild = torch.from_numpy(rng.integers(-40, 41, (2, 12, 16))
                            .astype(np.int32)).to(dev)
    for r, c in ((mv_r, mv_c), (wild[0], wild[1])):
        got = bme.subpel_refine16(src, ref, r, c)
        want = bme.subpel_plain(src, ref, r, c)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        # the half-pel motion takes fractional MVs
        assert bool((got[0] % 8 != 0).any())


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("qindex", [60, 160])
def test_inter_select_matches_plain(dev, k, qindex):
    rng = np.random.default_rng(k)
    H, W = 192, 256
    src, ref = _moving_pair(H, W, k)
    src_t = torch.from_numpy(src).to(dev)
    preds, mr, mc, sr, sc = [], [], [], [], []
    for i in range(k):
        r = torch.from_numpy(np.roll(ref, (i, -i), axis=(0, 1))).to(dev)
        me = bme.frame_me(src_t, r, 8, ((16, 16), (64, 64)))
        a, b, p = bme.subpel_refine16(
            src_t, r, bi._nested_to_grid(me[(16, 16)][0], 3, 4, 4, 4),
            bi._nested_to_grid(me[(16, 16)][1], 3, 4, 4, 4))
        preds.append(p)
        mr.append(a)
        mc.append(b)
        sr.append(me[(64, 64)][0].reshape(3, 4))
        sc.append(me[(64, 64)][1].reshape(3, 4))
    args = (src_t, torch.stack(preds), torch.stack(mr), torch.stack(mc),
            torch.stack(sr), torch.stack(sc), qindex, 250.0)
    before = bi.inter_select.launches
    f1, m1, c1 = bi.inter_select(*args)
    f2, m2, c2 = bi.inter_select_plain(*args)
    assert bi.inter_select.launches == before + 1
    for key in bi.SEL_KEYS:
        assert torch.equal(f1[key], f2[key]), key
    assert torch.equal(m1, m2)
    for s in omd.INTER_SHAPES:
        close = torch.isclose(c1[s], c2[s], rtol=2e-4, atol=2.0)
        assert close.float().mean().item() >= 0.99, s
    if k == 3:
        assert len(torch.unique(f1["sel"])) > 1


def test_inter_wrappers_refuse_what_the_kernels_do_not_take(dev):
    z = torch.zeros((128, 128), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        bme.me_coarse(z.to(torch.int32), z)
    with pytest.raises(ValueError):
        bme.me_coarse(z[:, :96].contiguous(), z[:, :96].contiguous())
    with pytest.raises(ValueError):
        bme.me_refine(z, z, torch.zeros((2, 2, 2), dtype=torch.int64,
                                        device=dev))
    with pytest.raises(ValueError):
        bme.subpel_refine16(z, z, torch.zeros((8, 8), dtype=torch.int32,
                                              device=dev),
                            torch.zeros((4, 8), dtype=torch.int32,
                                        device=dev))


def test_ipp_stream_on_the_card_equals_the_plain_stream(dev, tmp_path):
    frames = []
    rng = np.random.default_rng(9)
    base = _plane(160, 224, 4)
    for i in range(4):
        y = np.roll(base, (i, 2 * i), axis=(0, 1))[:128, :192]
        frames.append((np.ascontiguousarray(y),
                       rng.integers(100, 140, (64, 96)).astype(np.uint8),
                       rng.integers(110, 150, (64, 96)).astype(np.uint8)))
    cfg = EncoderConfig(source_width=192, source_height=128, qp=40,
                        enc_mode=8, intra_period_length=-1,
                        pred_structure=PredStructure.LOW_DELAY_P)
    out = {}
    for d in ("cuda", "cpu"):
        p = tmp_path / f"{d}.ivf"
        encode_ivf(frames, cfg, str(p), device=d)
        out[d] = p.read_bytes()
    assert out["cuda"] == out["cpu"]


def _unit_inputs(dev, H, W, shifts, seed):
    """(src, refs, preds, mvq_r, mvq_c, sb_r, sb_c) on the card: one
    pattern per reference; the source is the first pattern moved by the
    first shift on its left third and the average of the first two
    moved patterns elsewhere (a cross-fade, where compound wins), then
    through the path's own K5-K7."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    pats = [(110 + 60 * np.sin(xx / (9 + 4 * i) + i)
             + 40 * np.cos(yy / (7 + 3 * i))
             + rng.integers(-12, 13, (H, W))).clip(0, 255).astype(np.int32)
            for i in range(len(shifts))]
    moved = [np.roll(p, sh, axis=(0, 1)) for p, sh in zip(pats, shifts)]
    src = np.where(xx < W // 3, moved[0], (moved[0] + moved[1] + 1) // 2)
    src = (src + rng.integers(-2, 3, (H, W))).clip(0, 255).astype(np.uint8)
    src_t = torch.from_numpy(src).to(dev)
    ny, nx = H // 64, W // 64
    refs, parts = [], []
    for pat in pats:
        r = torch.from_numpy(pat.astype(np.uint8)).to(dev)
        me = bme.frame_me(src_t, r, 8, ((16, 16), (64, 64)))
        a, b, p = bme.subpel_refine16(
            src_t, r, bi._nested_to_grid(me[(16, 16)][0], ny, nx, 4, 4),
            bi._nested_to_grid(me[(16, 16)][1], ny, nx, 4, 4))
        refs.append(r)
        parts.append((p, a, b, me[(64, 64)][0].reshape(ny, nx),
                      me[(64, 64)][1].reshape(ny, nx)))
    return (src_t, torch.stack(refs).contiguous()) + tuple(
        torch.stack([q[i] for q in parts]).contiguous() for i in range(5))


@pytest.mark.parametrize("case", [
    ((0, 0), (7, -9)), ((2, -3), (-6, 5), (9, 11))], ids=["K2", "K3"])
@pytest.mark.parametrize("dists", ["near", "far"])
def test_compound_joint_and_its_row_match_plain(dev, case, dists):
    k = len(case)
    bwd = (False, True, True)[:k] if dists == "near" \
        else (True, False, True)[:k]
    rel = (-1, 1, 2)[:k] if dists == "near" else (3, -2, 5)[:k]
    src, refs, preds, mr, mc, sr, sc = _unit_inputs(dev, 192, 256, case, k)
    before = bi.compound_joint.launches
    got = bi.compound_joint(src, refs, preds, mr, mc, sr, sc, bwd, rel, 100)
    want = bi.compound_joint_plain(src, refs, preds, mr, mc, sr, sc, bwd,
                                   rel, 100)
    assert bi.compound_joint.launches == before + 1
    for key in bi.COMP_KEYS:
        assert torch.equal(got[key], want[key]), key
    args = (src, preds, mr, mc, sr, sc, 100, 250.0)
    f1, m1, c1 = bi.inter_select(*args, comp=got)
    f2, m2, c2 = bi.inter_select_plain(*args, comp=got)
    for key in bi.SEL_KEYS:
        assert torch.equal(f1[key], f2[key]), key
    assert torch.equal(m1, m2)
    for s in omd.INTER_SHAPES:
        close = torch.isclose(c1[s], c2[s], rtol=2e-4, atol=2.0)
        assert close.float().mean().item() >= 0.99, s
    assert bool((f1["sel"] == k).any())


@pytest.mark.parametrize("size", [(576, 960), (48, 80), (16, 16)])
def test_block_var16_matches_plain(dev, size):
    p = torch.from_numpy(_plane(*size, size[1])).to(dev)
    before = tpl.block_var16.launches
    got = tpl.block_var16(p)
    assert tpl.block_var16.launches == before + 1
    assert torch.equal(got, tpl.block_var16_plain(p))


@pytest.mark.parametrize("shape", [(32, 32), (16, 16)])
@pytest.mark.parametrize("size", [(192, 256), (320, 192)])
def test_me_single_shape_matches_plain(dev, shape, size):
    src, ref = (torch.from_numpy(p).to(dev) for p in _moving_pair(*size, 2))
    got = bme.frame_me(src, ref, shapes=(shape,))
    want = bme.refine_plain(src, ref, bme.coarse_sb_search(src, ref),
                            (shape,))
    for g, w in zip(got[shape], want[shape]):
        assert torch.equal(g, w)


def test_compound_wrappers_refuse_what_the_kernels_do_not_take(dev):
    src, refs, preds, mr, mc, sr, sc = _unit_inputs(
        dev, 128, 128, ((0, 0), (3, 3)), 1)
    with pytest.raises(ValueError):        # both references forward
        bi.compound_joint(src, refs, preds, mr, mc, sr, sc, (False, False),
                          (-1, -2), 100)
    with pytest.raises(ValueError):        # refs of another type
        bi.compound_joint(src, refs.to(torch.int32), preds, mr, mc, sr, sc,
                          (False, True), (-1, 1), 100)
    comp = bi.compound_joint(src, refs, preds, mr, mc, sr, sc, (False, True),
                             (-1, 1), 100)
    comp["sad"] = comp["sad"].to(torch.int64)
    with pytest.raises(ValueError):
        bi.inter_select(src, preds, mr, mc, sr, sc, 100, 250.0, comp=comp)
    with pytest.raises(ValueError):
        tpl.block_var16(torch.zeros((24, 32), dtype=torch.uint8, device=dev))
    with pytest.raises(ValueError):
        tpl.block_var16(torch.zeros((32, 32), dtype=torch.int32, device=dev))


def test_ra_stream_on_the_card_equals_the_plain_stream(dev, tmp_path):
    frames = []
    rng = np.random.default_rng(11)
    base = _plane(160, 224, 6)
    for i in range(5):
        y = np.roll(base, (i, 2 * i), axis=(0, 1))[:128, :192]
        frames.append((np.ascontiguousarray(y),
                       rng.integers(100, 140, (64, 96)).astype(np.uint8),
                       rng.integers(110, 150, (64, 96)).astype(np.uint8)))
    cfg = EncoderConfig(source_width=192, source_height=128, qp=40,
                        enc_mode=8, intra_period_length=-1,
                        hierarchical_levels=2)
    out = {}
    for d in ("cuda", "cpu"):
        p = tmp_path / f"{d}.ivf"
        encode_ivf(frames, cfg, str(p), device=d)
        out[d] = p.read_bytes()
    assert out["cuda"] == out["cpu"]


# -- stripe modes (the stripe step of svt_av1_tpu_torch/parallel) -----------

@pytest.mark.parametrize("row0", [0, 64, 192])
def test_me_stripe_modes_match_plain(dev, row0):
    src, ref = (torch.from_numpy(p).to(dev) for p in _moving_pair(256, 256,
                                                                  row0))
    stripe = src[row0:row0 + 64].contiguous()
    before = (bme.me_coarse.launches, bme.me_refine.launches,
              bme.subpel_refine16.launches)
    coarse = bme.me_coarse(stripe, ref, 8, row0)
    assert torch.equal(coarse, bme.coarse_sb_search(stripe, ref, 8, row0))
    got = bme.me_refine(stripe, ref, coarse, bme.ME_SHAPES, row0)
    want = bme.refine_plain(stripe, ref, coarse, bme.ME_SHAPES, row0)
    for s in bme.ME_SHAPES:
        for g, w in zip(got[s], want[s]):
            assert torch.equal(g, w), s
    mv_r = bi._nested_to_grid(got[(16, 16)][0], 1, 4, 4, 4)
    mv_c = bi._nested_to_grid(got[(16, 16)][1], 1, 4, 4, 4)
    sub = bme.subpel_refine16(stripe, ref, mv_r, mv_c, 8, row0)
    for g, w in zip(sub, bme.subpel_plain(stripe, ref, mv_r, mv_c, 8, row0)):
        assert torch.equal(g, w)
    assert (bme.me_coarse.launches, bme.me_refine.launches,
            bme.subpel_refine16.launches) == (before[0] + 1, before[1] + 1,
                                              before[2] + 1)
    # the stripe's outputs are the whole frame's rows
    whole = bme.frame_me(src, ref, 8, bme.ME_SHAPES)
    rows = slice(row0 // 64 * 4, row0 // 64 * 4 + 4)
    for s in bme.ME_SHAPES:
        for g, w in zip(got[s], whole[s]):
            assert torch.equal(g, w[rows]), s


@pytest.mark.parametrize("index", [0, 1, 2], ids=["first", "middle", "last"])
def test_intra_halo_mode_matches_plain(dev, index):
    plane = torch.from_numpy(_plane(192, 256, index)).to(dev)
    r0 = index * 64
    stripe = plane[r0:r0 + 64].contiguous()
    above = stripe[0] if index == 0 else plane[r0 - 1].contiguous()
    halo = stripe[-1:].expand(32, 256).contiguous() if index == 2 \
        else plane[r0 + 64:r0 + 96].contiguous()
    mb = tuple(np.linspace(1.0, 6.0, 13).tolist())
    for (w, h) in omd.ALL_SHAPES:
        m, c = omd.intra_decision(stripe, w, h, 140, 250.0, mb, 8, above,
                                  halo)
        m2, c2 = omd.intra_decision_plain(stripe, w, h, 140, 250.0, mb, 8,
                                          above, halo)
        assert (m == m2).float().mean().item() >= 0.99, (w, h)
        assert torch.isclose(c, c2, rtol=1e-5).float().mean().item() >= 0.99
        # the whole plane's decision on the stripe's rows
        mw, cw = omd.intra_decision(plane, w, h, 140, 250.0, mb)
        assert torch.equal(m, mw[r0 // h:(r0 + 64) // h]), (w, h)


@pytest.mark.parametrize("top,bottom", [(False, False), (True, False),
                                        (False, True), (True, True)],
                         ids=["none", "top", "bottom", "both"])
def test_cdef_halo_modes_match_plain(dev, top, bottom):
    full = torch.from_numpy(_plane(68, 256, 3).astype(np.int32)).to(dev)
    d = full[2:66].contiguous()
    src = (d + torch.randint(-5, 6, d.shape, device=dev)).clamp(0, 255) \
        .to(torch.uint8)
    rng = np.random.default_rng(top + 2 * bottom)
    ns = torch.from_numpy(rng.random((8, 32)) < 0.8).to(dev)
    halos = [(full[:2].contiguous() if top else None,
              full[66:].contiguous() if bottom else None)]
    dirs, var = cdef.cdef_direction(d, 256, 64)
    got = cdef.cdef_search([src], [d], dirs, var, ns, 256, 64, 4,
                           halos=halos)
    want = cdef.search_plain([src], [d], dirs, var, ns, 256, 64, 4,
                             halos=halos)
    assert torch.equal(got[0], want[0]) and got[1] is None
    for ys in (0, 33, 61):
        a = cdef.cdef_apply([d], ns, dirs, var, ys, 0, 4, 256, 64, 8, halos)
        b = cdef.cdef_apply_plain([d], ns, dirs, var, ys, 0, 4, 256, 64, 8,
                                  halos)
        assert torch.equal(a[0], b[0]), ys


def test_stripe_step_matches_the_plain_step_and_the_whole_frame(dev):
    from svt_av1_tpu_torch.parallel import dryrun, stripes

    rep = dryrun.dryrun_stripes(2, width=256, device=dev)
    assert min(rep["agreement"].values()) > 0.97
    plain = stripes.stripe_step(rep["frame"], rep["stripes"],
                                stripes.LocalStripes(2), plain=True)
    for a, b in zip(rep["outs"], plain):
        assert (a["level"], a["ystr"]) == (b["level"], b["ystr"])
        assert torch.equal(a["cdef"], b["cdef"])
        for k in ("mv_r", "mv_c", "sel"):
            assert torch.equal(a["fields"][k], b["fields"][k]), k


def test_decoder_on_the_card_equals_the_cpu_decoder(dev, tmp_path):
    from svt_av1_tpu_torch.api import Decoder

    frames = []
    base = _plane(160, 224, 8)
    for i in range(4):
        y = np.roll(base, (i, 2 * i), axis=(0, 1))[:128, :192]
        frames.append((np.ascontiguousarray(y),
                       np.full((64, 96), 120, np.uint8),
                       np.full((64, 96), 130, np.uint8)))
    cfg = EncoderConfig(source_width=192, source_height=128, qp=40,
                        enc_mode=8, intra_period_length=-1,
                        hierarchical_levels=2)
    path = tmp_path / "s.ivf"
    recon = encode_ivf(frames, cfg, str(path), device=dev)
    from svt_av1_tpu_torch.io import IvfReader

    pkts = [p for p, _ in IvfReader(str(path))]
    outs = {}
    for d in ("cuda", "cpu"):
        dec = Decoder(device=d)
        outs[d] = [g for g in (dec.decode_frame(p) for p in pkts)
                   if g is not None]
    assert len(outs["cuda"]) == len(outs["cpu"]) == len(recon)
    for a, b, r in zip(outs["cuda"], outs["cpu"], recon):
        for p in range(3):
            assert np.array_equal(a[p], b[p]) and np.array_equal(a[p], r[p])


def _nccl_worker(rank, n, store_path, inputs, out_path):
    import torch.distributed as dist
    from svt_av1_tpu_torch.parallel import stripes

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n, device_id=dev)
    try:
        frame, parts = torch.load(inputs, map_location=dev,
                                  weights_only=False)
        out = stripes.stripe_step(frame, [parts[rank]],
                                  stripes.DistStripes())
        torch.cuda.synchronize(dev)
        torch.save(out[0], f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def test_dist_stripes_over_nccl_equal_local_stripes(dev, tmp_path):
    """One stripe per card through NCCL (a machine with several cards):
    every output equals LocalStripes' on one card."""
    import time

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    from svt_av1_tpu_torch.parallel import dryrun, stripes

    cap = dryrun.capture_inter_frame(n, 256, dev)
    frame = dryrun.frame_params(cap, dev)
    parts = dryrun.build_stripes(cap, n, dev)
    local = stripes.stripe_step(frame, parts, stripes.LocalStripes(n))
    inputs = tmp_path / "inputs.pt"
    torch.save((frame, parts), inputs)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_nccl_worker,
                         args=(r, n, str(tmp_path / "store"), str(inputs),
                               str(tmp_path / "out")))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 300
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 0))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks still running after 300 s: {hung}"
    assert [p.exitcode for p in procs] == [0] * n
    for r, want in enumerate(local):
        got = torch.load(tmp_path / f"out.{r}", map_location=dev,
                         weights_only=False)
        assert (got["level"], got["ystr"]) == (want["level"], want["ystr"])
        for k in ("cdef", "dlf_sse", "cdef_err"):
            assert torch.equal(got[k], want[k]), (r, k)
        for k, v in want["fields"].items():
            assert torch.equal(got["fields"][k], v), (r, k)
        for s, (m, c) in want["intra"].items():
            assert torch.equal(got["intra"][s][0], m), (r, s)


# -- the Hopper redesigns of K1 and K6 ----------------------------------------

def _tie_plane(h, w):
    """Flat regions, vertical steps every 16 columns and horizontal steps
    every 8 rows: blocks where several intra modes predict equally well."""
    yy, xx = np.mgrid[0:h, 0:w]
    p = np.full((h, w), 128, np.int32)
    mid = slice(w // 3, 2 * w // 3)
    p[:, mid] = 64 + 32 * ((xx[:, mid] // 16) % 4)
    p[h // 2:, :w // 3] = 200 - 40 * ((yy[h // 2:, :w // 3] // 8) % 3)
    return p.astype(np.uint8)


@pytest.mark.parametrize("kind", ["textured", "ties"])
def test_fused_intra_decision_matches_plain(dev, kind):
    """One K1 launch for all 7 shapes of a 1920-wide plane, against the
    plain version per shape (modes equal on >= 99% of the blocks, costs
    within rtol 1e-5 on >= 99%); with equal mode bits the flat blocks tie
    in every mode, and the first mode must win.  The one-shape calls run
    the same kernel and give the fused call's values exactly."""
    h, w = 128, 1920
    plane = torch.from_numpy(_plane(h, w, 11) if kind == "textured"
                             else _tie_plane(h, w)).to(dev)
    mb = tuple(np.linspace(1.0, 6.0, 13).tolist()) if kind == "textured" \
        else (2.0,) * 13
    before = omd.intra_decision_packed.launches
    packed = omd.intra_decision_packed(plane, 140, 250.0, mb)
    assert omd.intra_decision_packed.launches == before + 1
    got = omd.unpack_decisions(packed, omd.ALL_SHAPES, w, h)
    for s in omd.ALL_SHAPES:
        m, c = got[s]
        m2, c2 = omd.intra_decision_plain(plane, *s, 140, 250.0, mb)
        assert (m == m2).float().mean().item() >= 0.99, s
        assert torch.isclose(c, c2, rtol=1e-5).float().mean().item() >= 0.99
        if kind == "ties":
            # DC predicts the block exactly: cost lam * 2 bits, which no
            # mode undercuts, so every mode ties at best and DC must win
            flat = (c2 == 250.0 * 2.0) & (m2 == 0)
            assert flat.any() and bool((m[flat] == 0).all()), s
        m1, c1 = omd.intra_decision(plane, *s, 140, 250.0, mb)
        assert torch.equal(m1, m) and torch.equal(c1, c), s
    assert omd.intra_decision_packed.launches == before + 1 + len(
        omd.ALL_SHAPES)


@pytest.mark.parametrize("mode", [int(m) for m in omd.DIR_MODES],
                         ids=[m.name for m in omd.DIR_MODES])
def test_each_directional_mode_alone_matches_plain(dev, mode):
    """K1's directional predictions one mode at a time: every other mode
    costs 1e7 bits more, so the mode is the only affordable one in every
    block of a textured 1920-wide plane, and the cost it reports follows
    its prediction of every pixel (at qindex 255 most coefficients sit in
    the dead zone and add their square).  Modes equal on 100% of the
    blocks of every shape, costs within rtol 1e-5 on 100%."""
    h, w = 128, 1920
    plane = torch.from_numpy(_plane(h, w, 17)).to(dev)
    mb = [1e7] * 13
    mb[mode] = 1.0
    packed = omd.intra_decision_packed(plane, 255, 250.0, mb)
    got = omd.unpack_decisions(packed, omd.ALL_SHAPES, w, h)
    for s in omd.ALL_SHAPES:
        m, c = got[s]
        m2, c2 = omd.intra_decision_plain(plane, *s, 255, 250.0, mb)
        assert bool((m2 == mode).all()), s
        assert torch.equal(m, m2), s
        assert bool(torch.isclose(c, c2, rtol=1e-5).all()), (
            s, (c - c2).abs().max().item())


def _tie_pair(kind, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "flat":
        ref = np.full((h, w), 97, np.uint8)
        return ref.copy(), ref
    ref = (100 + 30 * (xx % 8) + 7 * (yy % 8)).astype(np.uint8)
    return np.roll(ref, (2, 3), axis=(0, 1)), ref


@pytest.mark.parametrize("shapes", [bme.ME_SHAPES, ((16, 16), (64, 64)),
                                    ((32, 32),)],
                         ids=["all", "path", "mctf"])
@pytest.mark.parametrize("size", [(192, 256), (64, 320)],
                         ids=["frame", "one_sb_row"])
@pytest.mark.parametrize("kind", ["flat", "periodic", "moving"])
def test_me_refine_ties_and_borders_match_plain(dev, kind, size, shapes):
    """K6 against refine_plain where offsets tie (a flat plane: every
    offset; a period-8 plane: every eighth), on a moving pair, over frames
    whose SBs are border SBs and a plane of one SB row; with the coarse
    winners of K5 and with arbitrary ones (windows at any alignment)."""
    if kind == "moving":
        pair = _moving_pair(*size, 5)
    else:
        pair = _tie_pair(kind, *size)
    src, ref = (torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                for p in pair)
    if kind == "moving":
        # a reference that starts one byte past a 16-byte boundary: every
        # window takes the clamped byte path
        ref = torch.empty(ref.numel() + 16, dtype=torch.uint8, device=dev)[
            1:1 + ref.numel()].view(ref.shape).copy_(ref)
    rng = np.random.default_rng(size[1])
    n_sby, n_sbx = size[0] // 64, size[1] // 64
    for coarse in (bme.me_coarse(src, ref, 8), torch.from_numpy(
            rng.integers(-40, 41, (n_sby, n_sbx, 2)).astype(np.int32))
            .to(dev)):
        got = bme.me_refine(src, ref, coarse, shapes)
        want = bme.refine_plain(src, ref, coarse, shapes)
        for s in shapes:
            for g, w in zip(got[s], want[s]):
                assert torch.equal(g, w), s
        if (16, 16) in shapes:
            assert torch.equal(got["win16"], want["win16"])


# -- near-boundary coefficients in float64, and K8 and K4's search on the
# tensor cores and in their shared form ---------------------------------------

def _assert_k8_equals_plain(args, comp=None):
    """K8 against its plain version: the selection fields exactly, the MV
    bits within 1e-4, the costs within rtol 2e-4 / atol 2 on every block
    of every shape; one launch."""
    before = bi.inter_select.launches
    f1, m1, c1 = bi.inter_select(*args, comp=comp)
    f2, m2, c2 = bi.inter_select_plain(*args, comp=comp)
    assert bi.inter_select.launches == before + 1
    for key in bi.SEL_KEYS:
        assert torch.equal(f1[key], f2[key]), key
    assert (m1 - m2).abs().max().item() <= 1e-4
    for s in omd.INTER_SHAPES:
        close = torch.isclose(c1[s], c2[s], rtol=2e-4, atol=2.0)
        assert bool(close.all()), (s, (c1[s] - c2[s]).abs().max().item(),
                                   close.float().mean().item())
    return f1


def _k8_planes(kind, H, W, seed):
    """(src, ref) uint8: a textured picture moved by a fraction of a pixel
    plus noise ("textured"), uniform noise against noise ("noise", high
    energy in every band), or the textured picture moved by (13, -21)
    with its right half fading ("motion")."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        ref = rng.integers(0, 256, (H, W)).astype(np.uint8)
        src = np.roll(ref, (1, 2), axis=(0, 1)).astype(np.int32) \
            + rng.integers(-60, 61, (H, W))
        return src.clip(0, 255).astype(np.uint8), ref
    if kind == "textured":
        return _moving_pair(H, W, seed)
    ref = _plane(H, W, seed)
    src = np.roll(ref, (13, -21), axis=(0, 1)).astype(np.int32)
    src[:, W // 2:] = (src[:, W // 2:] * 3) // 4 + 40
    return (src + rng.integers(-3, 4, (H, W))).clip(0, 255).astype(
        np.uint8), ref


def _k8_args(dev, src, refs, qindex=160, lam=2500.0):
    H, W = src.shape
    src_t = torch.from_numpy(src).to(dev)
    ny, nx = H // 64, W // 64
    parts = []
    for ref in refs:
        r = torch.from_numpy(ref).to(dev)
        me = bme.frame_me(src_t, r, 8, ((16, 16), (64, 64)))
        a, b, p = bme.subpel_refine16(
            src_t, r, bi._nested_to_grid(me[(16, 16)][0], ny, nx, 4, 4),
            bi._nested_to_grid(me[(16, 16)][1], ny, nx, 4, 4))
        parts.append((p, a, b, me[(64, 64)][0].reshape(ny, nx),
                      me[(64, 64)][1].reshape(ny, nx)))
    return (src_t,) + tuple(torch.stack([q[i] for q in parts]).contiguous()
                            for i in range(5)) + (qindex, lam)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("kind", ["textured", "noise", "motion"])
def test_k8_matches_plain_on_every_block_at_1080p(dev, kind, k):
    """K8 on 1920x1088 planes with 1 and 3 references: every selection
    field equal, every cost of every shape within the gate."""
    src, ref = _k8_planes(kind, 1088, 1920, 3)
    refs = [np.roll(ref, (i, -2 * i), axis=(0, 1)) for i in range(k)]
    f = _assert_k8_equals_plain(_k8_args(dev, src, refs))
    if k == 3 and kind != "noise":
        assert len(torch.unique(f["sel"])) > 1


@pytest.mark.parametrize("qindex", [20, 160, 255])
def test_k8_one_sb_row_matches_plain(dev, qindex):
    """One row of SBs (64x1920), the shape of a stripe."""
    src, ref = _k8_planes("textured", 64, 1920, qindex)
    _assert_k8_equals_plain(_k8_args(dev, src, [ref], qindex, 250.0))


def test_k8_compound_row_matches_plain_at_1080p(dev):
    """K8 with K9's compound row at 1920x1088 (past and future
    reference), every block."""
    src, refs, preds, mr, mc, sr, sc = _unit_inputs(
        dev, 1088, 1920, ((2, -3), (-6, 5)), 6)
    comp = bi.compound_joint(src, refs, preds, mr, mc, sr, sc,
                             (False, True), (-1, 1), 160)
    f = _assert_k8_equals_plain((src, preds, mr, mc, sr, sc, 160, 2500.0),
                                comp)
    assert bool((f["sel"] == 2).any())


@pytest.mark.parametrize("kind", ["offset", "noise", "edges"])
def test_k8_high_energy_residuals_match_plain(dev, kind):
    """High-energy residuals, where the 64-point shapes' energy outside
    the coded 32x32 band matters: a flat offset of about 200 (all of it in
    the DC: a Parseval form would lose its float32 error), residual noise
    of full range (three quarters outside the band), and sharp edges every
    13 columns; the prediction is given directly (zero MVs)."""
    H, W = 256, 512
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:H, 0:W]
    if kind == "offset":
        src = 228 + rng.integers(-3, 4, (H, W))
        pred = 28 + rng.integers(-3, 4, (H, W))
    elif kind == "noise":
        src = rng.integers(0, 256, (H, W))
        pred = rng.integers(0, 256, (H, W))
    else:
        src = np.where((xx // 13) % 2, 250, 5) + 0 * yy
        pred = np.where((yy // 11) % 2, 240, 10) + 0 * xx
    src_t = torch.from_numpy(src.astype(np.uint8)).to(dev)
    pred_t = torch.from_numpy(pred.astype(np.uint8))[None].to(dev)
    z16 = torch.zeros((1, H // 16, W // 16), dtype=torch.int32, device=dev)
    z64 = torch.zeros((1, H // 64, W // 64), dtype=torch.int32, device=dev)
    for qindex, lam in ((60, 900.0), (255, 9000.0)):
        _assert_k8_equals_plain((src_t, pred_t.contiguous(), z16, z16.clone(),
                                 z64, z64.clone(), qindex, lam))


def test_k8_near_boundary_recomputes_are_counted(dev):
    """The kernels' near-boundary float64 recomputes show in their
    counters (K8 and K1), well under 1% of the coefficients they code."""
    src, ref = _k8_planes("textured", 1088, 1920, 4)
    omd.near_recomputes("inter_select")
    args = _k8_args(dev, src, [ref])
    stats = dict(omd.NEAR_STATS)
    bi.inter_select_plain(*args)
    coded = omd.NEAR_STATS["coded"] - stats["coded"]
    plain_near = omd.NEAR_STATS["near"] - stats["near"]
    bi.inter_select(*args)
    torch.cuda.synchronize()
    near = omd.near_recomputes("inter_select")
    assert 0 < near < 0.01 * coded and 0 < plain_near < 0.01 * coded
    assert omd.near_recomputes("inter_select") == 0
    plane = torch.from_numpy(_plane(1088, 1920, 4)).to(dev)
    omd.intra_decision_packed(plane, 160, 2500.0, (2.0,) * 13)
    torch.cuda.synchronize()
    assert omd.near_recomputes("intra_decision") > 0


@pytest.mark.parametrize("grid", ["fast", "full", "other"])
@pytest.mark.parametrize("halos", [False, True], ids=["frame", "stripe"])
def test_cdef_search_one_launch_over_three_planes(dev, grid, halos):
    """K4's search in one launch for luma and both chroma planes, on a
    random skip map at 1920x1080 (and, as a stripe, with every plane's
    neighbour rows above and below): both totals bit-equal to the plain
    version's, at the fast 5x3 grid, the full 8x4 grid and a set of
    another shape and order (the kernel's general instantiation)."""
    ps, ss = {"fast": (cdef.PRI_SET_FAST, cdef.SEC_SET_FAST),
              "full": (cdef.PRI_SET, cdef.SEC_SET),
              "other": ((4, 0, 12), (1, 3))}[grid]
    rng = np.random.default_rng(len(ps) + 2 * halos)
    fw, fh = (1920, 1080) if not halos else (1920, 64)
    H, W = -(-fh // 8) * 8, fw
    full = [torch.from_numpy(_plane((H >> s) + 4, W >> s, s + 7)
                             .astype(np.int32)).to(dev) for s in (0, 1, 1)]
    rec = [f[2:-2].contiguous() for f in full]
    src = [(r + torch.randint(-6, 7, r.shape, device=dev)).clamp(0, 255)
           .to(torch.uint8) for r in rec]
    dirs, var = cdef.cdef_direction(rec[0], fw, fh)
    ns = torch.from_numpy(rng.random(dirs.shape) < 0.6).to(dev)
    hal = [(f[:2].contiguous(), f[-2:].contiguous()) for f in full] \
        if halos else None
    before = cdef.cdef_search.launches
    got = cdef.cdef_search(src, rec, dirs, var, ns, fw, fh, 4, 8, ps, ss,
                           halos=hal)
    assert cdef.cdef_search.launches == before + 1
    want = cdef.search_plain(src, rec, dirs, var, ns, fw, fh, 4, 8, ps, ss,
                             halos=hal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    luma = cdef.cdef_search(src[:1], rec[:1], dirs, var, ns, fw, fh, 4, 8,
                            ps, ss, halos=hal[:1] if hal else None)
    assert torch.equal(luma[0], got[0]) and luma[1] is None


def _stripes_of(plane, row0s):
    """(stripe, the row above, 32 halo rows below) of a plane per row0."""
    H = plane.shape[0]
    out = []
    for r0 in row0s:
        stripe = plane[r0:r0 + 64].contiguous()
        halo = plane[r0 + 64:r0 + 96].contiguous() if r0 + 64 < H \
            else stripe[-1:].expand(32, plane.shape[1]).contiguous()
        out.append((stripe, plane[r0 - 1].contiguous(), halo))
    return out


@pytest.mark.parametrize("kind", ["ties", "textured"])
def test_intra_costs_equal_plain_on_every_block_of_1920_stripes(dev, kind):
    """C1: K1 in stripe mode on 1920x64 stripes of tie-heavy and textured
    planes, at three quantizers: modes equal and costs within rtol 1e-5 on
    100% of every shape's blocks."""
    h, w = 256, 1920
    plane = torch.from_numpy(_tie_plane(h, w) if kind == "ties"
                             else _plane(h, w, 21)).to(dev)
    mb = tuple(np.linspace(1.0, 6.0, 13).tolist())
    for qindex in (40, 140, 220):
        for stripe, above, halo in _stripes_of(plane, (64, 128, 192)):
            for (bw, bh) in omd.ALL_SHAPES:
                m, c = omd.intra_decision(stripe, bw, bh, qindex, 250.0, mb,
                                          8, above, halo)
                m2, c2 = omd.intra_decision_plain(stripe, bw, bh, qindex,
                                                  250.0, mb, 8, above, halo)
                assert torch.equal(m, m2), (qindex, bw, bh)
                assert bool(torch.isclose(c, c2, rtol=1e-5).all()), (
                    qindex, bw, bh, (c - c2).abs().max().item())


def test_stripe_step_costs_equal_the_plain_step_on_every_block(dev):
    """C1 on the stripe path: the kernels' step on 4 stripes of a coded
    1920x256 P frame against the plain versions' step: K1's modes equal
    and costs within rtol 1e-5, K8's costs within rtol 2e-4 / atol 2, on
    every block of every shape of every stripe."""
    from svt_av1_tpu_torch.parallel import dryrun, stripes

    rep = dryrun.dryrun_stripes(4, width=1920, device=dev)
    plain = stripes.stripe_step(rep["frame"], rep["stripes"],
                                stripes.LocalStripes(4), plain=True)
    for a, b in zip(rep["outs"], plain):
        for s, (m, c) in a["intra"].items():
            m2, c2 = b["intra"][s]
            assert torch.equal(m, m2), s
            assert bool(torch.isclose(c, c2, rtol=1e-5, atol=1e-8).all()), s
        for s, c in a["inter_cost"].items():
            assert bool(torch.isclose(c, b["inter_cost"][s], rtol=2e-4,
                                      atol=2.0).all()), s


# -- the Hopper redesigns of K7 and K9 ----------------------------------------

def _k7_equal(src, ref, mv_r, mv_c, row0=0):
    """K7 against subpel_plain: MVs and prediction plane exactly; one
    launch."""
    before = bme.subpel_refine16.launches
    got = bme.subpel_refine16(src, ref, mv_r, mv_c, 8, row0)
    assert bme.subpel_refine16.launches == before + 1
    want = bme.subpel_plain(src, ref, mv_r, mv_c, 8, row0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


def _edge_mvs(rng, nr, nc, H, W):
    """Full-pel MVs that put the patch past each edge of an H x W
    reference (beyond the 24-sample pad, where the origin clips) or
    anywhere between."""
    r = rng.integers(-H - 40, H + 41, (nr, nc))
    c = rng.integers(-W - 40, W + 41, (nr, nc))
    r[0, :], c[:, 0] = -H - 40, -W - 40
    r[-1, :], c[:, -1] = H + 40, W + 40
    return (torch.from_numpy(r.astype(np.int32)).contiguous(),
            torch.from_numpy(c.astype(np.int32)).contiguous())


@pytest.mark.parametrize("size", [(192, 256), (64, 1920)],
                         ids=["frame", "one_sb_row"])
@pytest.mark.parametrize("kind", ["flat", "periodic"])
def test_k7_ties_take_the_first_candidate_as_plain(dev, kind, size):
    """Flat planes (every candidate ties on SAD; the rate term and the
    SUBPEL_DELTAS order decide) and period-8 planes, on a frame and on
    one SB row, with zero, small and edge-reaching MVs."""
    H, W = size
    pair = _tie_pair(kind, H, W)
    src, ref = (torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                for p in pair)
    rng = np.random.default_rng(W)
    nr, nc = H // 16, W // 16
    mvs = [(torch.zeros((nr, nc), dtype=torch.int32),) * 2,
           tuple(torch.from_numpy(rng.integers(-3, 4, (nr, nc)).astype(
               np.int32)) for _ in range(2)),
           _edge_mvs(rng, nr, nc, H, W)]
    for r, c in mvs:
        _k7_equal(src, ref, r.to(dev), c.to(dev))


def test_k7_mvs_past_every_edge_match_plain(dev):
    """Textured planes with patches clamped at the four edges and
    corners: the 24x24 patch of clamped reads."""
    src, ref = (torch.from_numpy(p).to(dev) for p in _moving_pair(192, 256,
                                                                  21))
    rng = np.random.default_rng(21)
    for _ in range(3):
        r, c = _edge_mvs(rng, 12, 16, 192, 256)
        _k7_equal(src, ref, r.to(dev), c.to(dev))


@pytest.mark.parametrize("row0", [64, 512, 1024])
def test_k7_stripe_of_a_1920_reference_matches_plain(dev, row0):
    """K7's stripe mode: a 64-row stripe at row0 of a 1920x1088
    reference, with the ME's MVs and edge-reaching ones; the stripe's
    rows of the whole frame's run are the same."""
    src, ref = (torch.from_numpy(p).to(dev)
                for p in _moving_pair(1088, 1920, row0))
    stripe = src[row0:row0 + 64].contiguous()
    me = bme.frame_me(src, ref, 8, ((16, 16),))
    mv_r = bi._nested_to_grid(me[(16, 16)][0], 17, 30, 4, 4)
    mv_c = bi._nested_to_grid(me[(16, 16)][1], 17, 30, 4, 4)
    whole = _k7_equal(src, ref, mv_r, mv_c)
    k = row0 // 16
    part = _k7_equal(stripe, ref, mv_r[k:k + 4].contiguous(),
                     mv_c[k:k + 4].contiguous(), row0)
    assert torch.equal(part[0], whole[0][k:k + 4])
    assert torch.equal(part[1], whole[1][k:k + 4])
    assert torch.equal(part[2], whole[2][row0:row0 + 64])
    r, c = _edge_mvs(np.random.default_rng(row0), 4, 120, 1088, 1920)
    _k7_equal(stripe, ref, r.to(dev), c.to(dev), row0)


def _k9_inputs(dev, src, refs, mvs=None, seed=0, bd=8):
    """(src, refs, preds, mvq_r, mvq_c, sb_r, sb_c) on the card from numpy
    planes (uint8 at ``bd`` 8, int16 at 10): each reference through the
    path's K5-K7, or, with ``mvs``, arbitrary quarter-pel MV fields (and
    SB winners) beside the predictions K7 made."""
    H, W = src.shape
    src_t = torch.from_numpy(np.ascontiguousarray(src)).to(dev)
    ny, nx = H // 64, W // 64
    rng = np.random.default_rng(seed)
    parts = []
    for ref in refs:
        r = torch.from_numpy(np.ascontiguousarray(ref)).to(dev)
        me = bme.frame_me(src_t, r, 8, ((16, 16), (64, 64)))
        a, b, p = bme.subpel_refine16(
            src_t, r, bi._nested_to_grid(me[(16, 16)][0], ny, nx, 4, 4),
            bi._nested_to_grid(me[(16, 16)][1], ny, nx, 4, 4), bd)
        sr, sc = me[(64, 64)][0].reshape(ny, nx), me[(64, 64)][1].reshape(
            ny, nx)
        if mvs == "edges":
            # seeds that mirror past every edge of the plane
            big = [torch.from_numpy((rng.integers(-lim, lim + 1,
                                                  (H // 16, W // 16)) & ~1)
                                    .astype(np.int32)).to(dev)
                   for lim in (8 * H + 900, 8 * W + 900)]
            a, b = big
            sr = torch.from_numpy(rng.integers(-60, 61, (ny, nx)).astype(
                np.int32)).to(dev)
            sc = torch.from_numpy(rng.integers(-60, 61, (ny, nx)).astype(
                np.int32)).to(dev)
        parts.append((p, a, b, sr, sc))
    return (src_t, torch.stack([torch.from_numpy(np.ascontiguousarray(r))
                                for r in refs]).to(dev).contiguous()) + \
        tuple(torch.stack([q[i] for q in parts]).contiguous()
              for i in range(5))


def _k9_equal(args, bwd, rel, qindex=100):
    before = bi.compound_joint.launches
    got = bi.compound_joint(*args, bwd, rel, qindex)
    assert bi.compound_joint.launches == before + 1
    want = bi.compound_joint_plain(*args, bwd, rel, qindex)
    for key in bi.COMP_KEYS:
        assert torch.equal(got[key], want[key]), key
    return got


@pytest.mark.parametrize("kind", ["flat", "periodic"])
def test_k9_ties_between_offsets_and_picks_match_plain(dev, kind):
    """Flat references (every offset ties, and the plain average ties
    with both refined arms: the first pick must win) and period-8 ones
    (ties every eighth offset)."""
    src, ref = _tie_pair(kind, 192, 256)
    refs = [ref, np.roll(ref, (8, -8), axis=(0, 1))]
    args = _k9_inputs(dev, src, refs)
    got = _k9_equal(args, (False, True), (-1, 1))
    if kind == "flat":
        # every pair predicts the source exactly: the plain average, the
        # first of the three, keeps both arms' MVs
        assert bool((got["sad"] == 0).all())
        assert torch.equal(got["mv_r"], args[3][0])
        assert torch.equal(got["mv1_c"], args[4][1])


@pytest.mark.parametrize("size", [(192, 256), (64, 1920)],
                         ids=["frame", "one_sb_row"])
def test_k9_windows_clipped_at_every_edge_match_plain(dev, size):
    """MV fields whose mirrored seeds put the 22x22 window past each edge
    of the plane (the origin clips to the MC_PAD pad, the reads clamp);
    the realized MVs come from the clipped origins."""
    H, W = size
    src, ref = _moving_pair(H, W, 9)
    refs = [ref, np.roll(ref, (3, 5), axis=(0, 1))]
    for seed in range(3):
        args = _k9_inputs(dev, src, refs, "edges", seed)
        _k9_equal(args, (False, True), (-2, 3))
        _k9_equal(args, (True, False), (1, -1))


@pytest.mark.parametrize("size", [(64, 1920), (128, 1920), (1152, 1920)],
                         ids=["one_sb_row", "two_sb_rows", "1920x1152"])
def test_k9_wave_shapes_match_plain(dev, size):
    """One and two SB rows of a 1920-wide frame, and the random-access
    path's 1920x1152 (2,160 blocks of four units)."""
    H, W = size
    src, ref = _moving_pair(H, W, H)
    refs = [ref, np.roll(ref, (-6, 5), axis=(0, 1))]
    args = _k9_inputs(dev, src, refs)
    got = _k9_equal(args, (False, True), (-1, 1))
    refined = (got["mv1_r"] != args[4][1]) | (got["mv_r"] != args[4][0])
    assert bool(refined.any())


@pytest.mark.parametrize("mask", [m for m in range(1, 7)],
                         ids=lambda m: "".join("B" if (m >> k) & 1 else "F"
                                               for k in range(3)))
def test_k9_three_references_each_backward_mask_match_plain(dev, mask):
    """K = 3 with every backward mask that leaves references on both
    sides: the first minimum over each side and the distance-scaled
    mirrors."""
    src, refs, preds, mr, mc, sr, sc = _unit_inputs(
        dev, 192, 256, ((2, -3), (-6, 5), (9, 11)), mask)
    bwd = tuple(bool((mask >> k) & 1) for k in range(3))
    rel = tuple((k + 1) * (1 if b else -1) for k, b in enumerate(bwd))
    _k9_equal((src, refs, preds, mr, mc, sr, sc), bwd, rel)


def test_k9_refuses_planes_off_16_byte_boundaries(dev):
    src, refs, preds, mr, mc, sr, sc = _unit_inputs(
        dev, 64, 128, ((1, 2), (-2, 1)), 0)
    shifted = torch.empty(src.numel() + 16, dtype=torch.uint8, device=dev)[
        1:1 + src.numel()].view(src.shape)
    shifted.copy_(src)
    with pytest.raises(ValueError):
        bi.compound_joint(shifted, refs, preds, mr, mc, sr, sc,
                          (False, True), (-1, 1), 100)


# -- PR 8: K5 and K2 in one launch per call --------------------------------

K5_RADII = (8, 12, 16, 24, 32)


def _k5_equal(src, ref, r, row0=0):
    """K5 against the plain version, one launch per call."""
    want = bme.coarse_sb_search(src, ref, r, row0)
    before = (bme.me_coarse.calls, bme.me_coarse.launches)
    got = bme.me_coarse(src, ref, r, row0)
    assert (bme.me_coarse.calls, bme.me_coarse.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, want), (r, row0)
    return want


@pytest.mark.parametrize("r", K5_RADII)
def test_k5_1080p_matches_plain_at_every_radius(dev, r):
    src, ref = (torch.from_numpy(p).to(dev) for p in _moving_pair(1152, 1920,
                                                                  r))
    # a large motion as well, which the wide reaches find
    far = torch.roll(ref, (7 * r, -5 * r), (0, 1)).contiguous()
    for rk in (ref, far):
        _k5_equal(src, rk, r)


@pytest.mark.parametrize("shape", [(64, 1920), (1152, 64)],
                         ids=["one_sb_row", "one_sb_column"])
@pytest.mark.parametrize("r", K5_RADII)
def test_k5_one_sb_row_and_column_match_plain(dev, shape, r):
    src, ref = (torch.from_numpy(p).to(dev) for p in _moving_pair(*shape, r))
    _k5_equal(src, ref, r)


@pytest.mark.parametrize("row0", [0, 64, 512, 1024])
@pytest.mark.parametrize("r", [8, 24])
def test_k5_stripes_of_a_1088_reference_match_plain(dev, row0, r):
    src, ref = (torch.from_numpy(p).to(dev) for p in _moving_pair(1088, 1920,
                                                                  row0))
    stripe = src[row0:row0 + 64].contiguous()
    got = _k5_equal(stripe, ref, r, row0)
    whole = bme.coarse_sb_search(src, ref, r)
    assert torch.equal(got, whole[row0 // 64:row0 // 64 + 1])


@pytest.mark.parametrize("kind", ["flat", "period8"])
@pytest.mark.parametrize("r", [8, 24])
def test_k5_ties_take_the_first_offset_as_plain(dev, kind, r):
    if kind == "flat":
        p = np.full((256, 320), 90, np.uint8)
    else:
        xx = np.mgrid[0:256, 0:320][1]
        p = (100 + 40 * ((xx // 8) % 2)).astype(np.uint8)
    src = torch.from_numpy(p).to(dev)
    _k5_equal(src, src, r)
    _k5_equal(src, torch.roll(src, (0, 16), (0, 1)).contiguous(), r)


@pytest.mark.parametrize("r", [8, 24])
def test_k5_planes_off_8_byte_boundaries_match_plain(dev, r):
    src, ref = _moving_pair(192, 256, r)
    planes = []
    for k, p in enumerate((src, ref)):
        buf = torch.empty(p.size + 16, dtype=torch.uint8, device=dev)
        planes.append(buf[1 + k:1 + k + p.size].view(p.shape).copy_(
            torch.from_numpy(p).to(dev)))
    _k5_equal(*planes, r)
    with pytest.raises(ValueError):
        bme.me_coarse(*planes, 33)


def _smooth_plane(h, w, seed, bd=8, block=8):
    """Flat blocks with steps of a few levels and 0/1 noise: every filter
    size passes its flatness tests on many lines."""
    rng = np.random.default_rng(seed)
    rows = np.cumsum(rng.integers(-2, 3, h // block + 1))
    cols = np.cumsum(rng.integers(-2, 3, w // block + 1))
    base = 120 + rows[:, None] + cols[None, :]
    p = np.repeat(np.repeat(base, block, 0), block, 1)[:h, :w]
    p = p + rng.integers(0, 2, (h, w))
    return (p.clip(0, 255) << (bd - 8)).astype(np.int32)


def _k2_check(dev, plane, prm, vw, vh, lv, lh, sharpness=0, bd=8):
    """K2 against the plain version: one launch, the input untouched."""
    p = torch.from_numpy(plane).to(dev)
    keep = p.clone()
    prm = [torch.from_numpy(np.ascontiguousarray(a, np.uint8)).to(dev)
           for a in prm]
    before = (dlf.deblock.calls, dlf.deblock.launches)
    got = dlf.deblock(p, *prm, vw, vh, lv, lh, sharpness, bd)
    assert (dlf.deblock.calls, dlf.deblock.launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = dlf.loop_filter_plane_full(p, *prm, vw, vh, lv, lh, sharpness, bd)
    assert torch.equal(got, want)
    assert torch.equal(p, keep)
    return got, p


@pytest.mark.parametrize("kind", ["noisy", "smooth"])
@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_k2_1080p_matches_plain_with_every_size(dev, kind, chroma):
    h, w, vw, vh = (576, 960, 960, 540) if chroma else (1152, 1920, 1920,
                                                        1080)
    plane = _smooth_plane(h, w, 5 + chroma) if kind == "smooth" \
        else _plane(h, w, 5 + chroma).astype(np.int32)
    prm = _edge_inputs(h, w, vw, vh, chroma, 9 + chroma)
    for lv in (8, 32, 63):
        got, p = _k2_check(dev, plane, prm, vw, vh, lv, lv)
        assert not torch.equal(got, p)
    if kind == "smooth":
        # each filter size changes samples on its own
        for s in ((4, 6) if chroma else (4, 8, 14)):
            only = (prm[0] & (prm[1] == s), prm[1], prm[2] & (prm[3] == s),
                    prm[3])
            got, p = _k2_check(dev, plane, only, vw, vh, 32, 32)
            assert not torch.equal(got, p), s


@pytest.mark.parametrize("d", [-12, -8, -4, 4, 8, 12])
def test_k2_14_tap_edges_near_tile_boundaries_match_plain(dev, d):
    h, w = 320, 384
    plane = np.full((h, w), 100, np.int32)
    x4, y4 = w // 4, h // 4
    apply_v = np.zeros((y4, x4 - 1), bool)
    apply_h = np.zeros((y4 - 1, x4), bool)
    for b in (64, 128, 256):                # tile boundaries
        at = b + d
        plane[:, at:] += 16
        plane[at:, :] += 12
        apply_v[:, at // 4 - 1] = True
        apply_h[at // 4 - 1, :] = True
    prm = (apply_v, np.full(apply_v.shape, 14, np.uint8), apply_h,
           np.full(apply_h.shape, 14, np.uint8))
    got, p = _k2_check(dev, plane.clip(0, 255), prm, w, h, 30, 30)
    assert not torch.equal(got, p)


@pytest.mark.parametrize("vis", [(1917, 1077), (1900, 1070), (130, 70)])
def test_k2_odd_visible_sizes_match_plain(dev, vis):
    vw, vh = vis
    h, w = -(-vh // 64) * 64, -(-vw // 64) * 64
    for chroma in (False, True):
        prm = _edge_inputs(h, w, vw, vh, chroma, vw)
        _k2_check(dev, _smooth_plane(h, w, vh), prm, vw, vh, 40, 40)
    # a plane that is no multiple of the tile either
    h2, w2 = 4 * ((vh + 3) // 4) + 2, 4 * ((vw + 3) // 4) + 6
    prm = _edge_inputs(h2 - h2 % 4, w2 - w2 % 4, vw, vh, False, vh)
    _k2_check(dev, _smooth_plane(h2, w2, vw), prm, vw, vh, 40, 40)


@pytest.mark.parametrize("case", ["decoder_levels", "level_v_0",
                                  "level_h_0", "bd10", "bd10_chroma"])
def test_k2_two_levels_and_bd10_match_plain(dev, case):
    chroma = "chroma" in case
    bd = 10 if "bd10" in case else 8
    lv, lh = {"decoder_levels": (14, 37), "level_v_0": (0, 25),
              "level_h_0": (25, 0), "bd10": (30, 18),
              "bd10_chroma": (22, 63)}[case]
    h, w, vw, vh = 576, 960, 950, 540
    plane = _smooth_plane(h, w, lv + lh, bd)
    prm = _edge_inputs(h, w, vw, vh, chroma, lv)
    for sharpness in (0, 5):
        got, p = _k2_check(dev, plane, prm, vw, vh, lv, lh, sharpness, bd)
        assert not torch.equal(got, p)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_k2_samples_at_both_ends_of_the_range_match_plain(dev, bd):
    """K2's domain is [0, 2^bd): planes that reach 0 and 2^bd - 1 over
    flat areas, where every filter size changes samples, equal the plain
    version."""
    h, w = 256, 320
    low = np.clip(_smooth_plane(h, w, bd, bd) - (118 << (bd - 8)), 0, None)
    prm = _edge_inputs(h, w, w, h, False, bd)
    for plane in (low, (1 << bd) - 1 - low):
        assert plane.min() == 0 or plane.max() == (1 << bd) - 1
        for lv in (20, 63):
            got, p = _k2_check(dev, plane.astype(np.int32), prm, w, h, lv,
                               lv, 0, bd)
            assert not torch.equal(got, p)


def test_k2_both_levels_0_copy_the_plane_in_one_launch(dev):
    plane = _smooth_plane(128, 192, 1)
    got, p = _k2_check(dev, plane, _edge_inputs(128, 192, 192, 128, False,
                                                  1), 192, 128, 0, 0)
    assert torch.equal(got, p) and got.data_ptr() != p.data_ptr()


# -- K4's apply and K3, one launch each (kernels/csrc/cdef_filter.cu,
# cdef_direction.cu)

def _k4_apply_check(planes, ns, fw, fh, ys, us, damping=5, bd=8,
                    halos=None):
    """K4's apply against the plain version: one launch for all the planes,
    new outputs, the input untouched."""
    dirs, var = cdef.direction_plain(planes[0], fw, fh, max(bd - 8, 0))
    keep = [p.clone() for p in planes]
    before = (cdef.cdef_apply.calls, cdef.cdef_apply.launches)
    got = cdef.cdef_apply(planes, ns, dirs, var, ys, us, damping, fw, fh, bd,
                          halos)
    assert (cdef.cdef_apply.calls, cdef.cdef_apply.launches) == (
        before[0] + 1, before[1] + 1)
    want = cdef.cdef_apply_plain(planes, ns, dirs, var, ys, us, damping, fw,
                                 fh, bd, halos)
    for pli, (g, w, p, k) in enumerate(zip(got, want, planes, keep)):
        assert torch.equal(g, w), (pli, ys, us)
        assert torch.equal(p, k) and g.data_ptr() != p.data_ptr()
        assert g.is_contiguous() and g.shape == p.shape
    return got


def _k4_planes(dev, shapes, seed, smooth=False, bd=8):
    out = []
    for i, (h, w) in enumerate(shapes):
        p = _smooth_plane(h, w, seed + i) if smooth \
            else _plane(h, w, seed + i).astype(np.int32)
        out.append(torch.from_numpy(p.astype(np.int32) << (bd - 8)).to(dev))
    return out


def _k4_ns(dev, fw, fh, seed, frac=0.8):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((-(-fh // 8), -(-fw // 8))) < frac) \
        .to(dev)


@pytest.mark.parametrize("kind", ["noisy", "smooth"])
@pytest.mark.parametrize("n", [1, 3], ids=["luma", "three_planes"])
def test_k4_apply_1080p_matches_plain(dev, kind, n):
    planes = _k4_planes(dev, [(1152, 1920), (576, 960), (576, 960)][:n], 3,
                        kind == "smooth")
    ns = _k4_ns(dev, 1920, 1080, n)
    for ys, us in ((33, 18), (63, 61), (4 * 1 + 2, 3), (14, 0)):
        got = _k4_apply_check(planes, ns, 1920, 1080, ys, us)
        assert not torch.equal(got[0], planes[0])


@pytest.mark.parametrize("top,bottom", [(False, False), (True, False),
                                        (False, True), (True, True)],
                         ids=["none", "top", "bottom", "both"])
def test_k4_apply_halo_modes_at_1920x64_match_plain(dev, top, bottom):
    full = _k4_planes(dev, [(68, 1920), (36, 960), (36, 960)], 5)
    planes = [f[2:-2].contiguous() for f in full]
    halos = [(f[:2].contiguous() if top else None,
              f[-2:].contiguous() if bottom else None) for f in full]
    ns = _k4_ns(dev, 1920, 64, top + 2 * bottom)
    for ys, us in ((61, 22), (33, 7)):
        _k4_apply_check(planes, ns, 1920, 64, ys, us, 4, 8, halos)


@pytest.mark.parametrize("frame", [(1920, 1080), (1917, 1077), (130, 98)],
                         ids=["1080p", "1917x1077", "130x98"])
def test_k4_apply_decoder_buffers_larger_than_the_frame(dev, frame):
    fw, fh = frame
    bh, bw = -(-fh // 64) * 64 + 32, -(-fw // 64) * 64 + 64
    planes = _k4_planes(dev, [(bh, bw), (bh // 2, bw // 2),
                              (bh // 2, bw // 2)], fw)
    got = _k4_apply_check(planes, _k4_ns(dev, fw, fh, 1), fw, fh, 45, 29)
    for pli, (g, p) in enumerate(zip(got, planes)):
        s = int(pli > 0)
        assert torch.equal(g[fh >> s:], p[fh >> s:])
        assert torch.equal(g[:, fw >> s:], p[:, fw >> s:])


@pytest.mark.parametrize("case", ["widths_off_4", "off_16_bytes"])
def test_k4_apply_unaligned_planes_match_plain(dev, case):
    """Rows that are no multiple of 4 samples, and planes and halo rows
    that start off 16-byte boundaries (views at an offset of one sample):
    the kernel's scalar path."""
    if case == "widths_off_4":
        fw, fh = 1918, 1078
        shapes = [(1080, 1918), (540, 959), (540, 959)]
    else:
        fw, fh = 1920, 1080
        shapes = [(1080, 1920), (540, 960), (540, 960)]
    src = _k4_planes(dev, [(h + 4, w) for h, w in shapes], 8)
    planes, halos = [], []
    for s in src:
        if case == "off_16_bytes":
            buf = torch.empty(s.numel() + 1, dtype=torch.int32, device=dev)
            s = buf[1:].view(s.shape).copy_(s)
        h = s.shape[0] - 4
        rows = s.view(-1)
        w = s.shape[1]
        planes.append(rows[2 * w:(2 + h) * w].view(h, w))
        halos.append((rows[:2 * w].view(2, w),
                      rows[(2 + h) * w:].view(2, w)))
    ns = _k4_ns(dev, fw, fh, 7)
    _k4_apply_check(planes, ns, fw, fh, 37, 26)
    _k4_apply_check(planes, ns, fw, fh, 37, 26, halos=halos)


def test_k4_apply_every_unit_skip_and_zero_strengths_copy(dev):
    planes = _k4_planes(dev, [(1152, 1920), (576, 960), (576, 960)], 4)
    for ns, ys, us in ((_k4_ns(dev, 1920, 1080, 0, 0.0), 33, 18),
                       (_k4_ns(dev, 1920, 1080, 0), 0, 0)):
        got = _k4_apply_check(planes, ns, 1920, 1080, ys, us)
        for g, p in zip(got, planes):
            assert torch.equal(g, p)
    # one plane's strengths 0: that plane is copied, the others filtered
    got = _k4_apply_check(planes, _k4_ns(dev, 1920, 1080, 1), 1920, 1080, 0,
                          18)
    assert torch.equal(got[0], planes[0])
    assert not torch.equal(got[1], planes[1])


@pytest.mark.parametrize("n", [1, 3])
def test_k4_apply_bd10_matches_plain(dev, n):
    planes = _k4_planes(dev, [(576, 960), (288, 480), (288, 480)][:n], 2,
                        bd=10)
    ns = _k4_ns(dev, 950, 540, 10)
    for ys, us in ((33, 18), (63, 7), (3, 61)):
        _k4_apply_check(planes, ns, 950, 540, ys, us, 5, 10)


def _k3_check(plane, fw, fh, cs=0):
    before = (cdef.cdef_direction.calls, cdef.cdef_direction.launches)
    d, v = cdef.cdef_direction(plane, fw, fh, cs)
    assert (cdef.cdef_direction.calls, cdef.cdef_direction.launches) == (
        before[0] + 1, before[1] + 1)
    d2, v2 = cdef.direction_plain(plane, fw, fh, cs)
    assert torch.equal(d, d2) and torch.equal(v, v2)
    assert d.is_contiguous() and v.is_contiguous()
    return d, v


@pytest.mark.parametrize("cs", [0, 2])
def test_k3_1080p_matches_plain(dev, cs):
    plane = torch.from_numpy(_plane(1152, 1920, 4).astype(np.int32) << cs) \
        .to(dev)
    d, _ = _k3_check(plane, 1920, 1080, cs)
    assert len(torch.unique(d)) == 8


def test_k3_tie_units_match_plain(dev):
    """Flat units (all 8 directions tie) and periodic ones (some tie)."""
    units = []
    for a in range(4):
        for b in range(4):
            for p in (2, 3, 4):
                for lo, hi in ((0, 255), (100, 140), (7, 7)):
                    i, j = np.mgrid[0:8, 0:8]
                    units.append(np.where((a * i + b * j) % p == 0, hi, lo))
    units = np.array(units)                              # 144 units
    tiled = np.resize(units, (135 * 240, 8, 8)).reshape(135, 240, 8, 8) \
        .transpose(0, 2, 1, 3).reshape(1080, 1920).astype(np.int32)
    d, v = _k3_check(torch.from_numpy(tiled).to(dev), 1920, 1080)
    assert (d == 0).any() and (d > 0).any()


@pytest.mark.parametrize("frame", [(1917, 1077), (530, 77)])
def test_k3_odd_frame_sizes_match_plain(dev, frame):
    fw, fh = frame
    src = torch.from_numpy(_plane(fh + 3, fw, 5).astype(np.int32)).to(dev)
    _k3_check(src, fw, fh)
    # a plane off 16-byte boundaries
    buf = torch.empty(src.numel() + 1, dtype=torch.int32, device=dev)
    _k3_check(buf[1:].view(src.shape).copy_(src), fw, fh)


# -- 10-bit all-intra: the 16-bit forms of K1 and of K4's search, and K2-K4
# at bd 10 (kernels/csrc/intra_decision.cu, cdef_filter.cu)

def _plane10(h, w, seed):
    """A textured 10-bit plane over most of [0, 1024), as int16."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return (480 + 320 * np.sin(xx / 11) + 160 * np.cos(yy / 7)
            + rng.integers(-48, 49, (h, w))).clip(0, 1023).astype(np.int16)


def _tie_plane10(h, w):
    return (_tie_plane(h, w).astype(np.int16) << 2) + 3


def _extreme_plane10(h, w, seed):
    """8x8 blocks at 0 or 1023 with a few samples at the other end: the
    ends of the 10-bit range packed side by side (K1 keeps three 10-bit
    samples to a register)."""
    rng = np.random.default_rng(seed)
    blocks = rng.random((h // 8, w // 8)) < 0.5
    p = np.repeat(np.repeat(blocks, 8, 0), 8, 1) ^ (rng.random((h, w)) < 0.1)
    return np.where(p, 1023, 0).astype(np.int16)


@pytest.mark.parametrize("kind", ["textured", "ties", "extremes"])
@pytest.mark.parametrize("qindex", [60, 160])
def test_k1_16bit_1080p_matches_plain(dev, kind, qindex):
    """K1's 16-bit form on a 1920x1088 10-bit plane, all 7 shapes in one
    launch: modes equal to the plain version's on every block, costs
    within rtol 1e-5 on >= 99% of each shape's blocks (the 8-bit gate)."""
    h, w = 1088, 1920
    plane = {"textured": lambda: _plane10(h, w, qindex),
             "ties": lambda: _tie_plane10(h, w),
             "extremes": lambda: _extreme_plane10(h, w, qindex)}[kind]()
    plane = torch.from_numpy(plane).to(dev)
    lam = 250.0 * 16                    # rd_lambda scales by 4^(bd - 8)
    mb = tuple(np.linspace(1.0, 6.0, 13).tolist())
    before = omd.intra_decision_packed.launches
    packed = omd.intra_decision_packed(plane, qindex, lam, mb, 10)
    assert omd.intra_decision_packed.launches == before + 1
    got = omd.unpack_decisions(packed, omd.ALL_SHAPES, w, h)
    for s in omd.ALL_SHAPES:
        m, c = got[s]
        m2, c2 = omd.intra_decision_plain(plane, *s, qindex, lam, mb, 10)
        assert torch.equal(m, m2), (s, (m == m2).float().mean().item())
        assert torch.isclose(c, c2, rtol=1e-5).float().mean().item() >= 0.99


def test_k1_16bit_stripe_mode_matches_plain(dev):
    """K1's 16-bit form on 1920x64 stripes with their int16 neighbour rows:
    equal to the plain version, and to the whole plane's rows."""
    plane = torch.from_numpy(_plane10(256, 1920, 3)).to(dev)
    mb = tuple(np.linspace(1.0, 6.0, 13).tolist())
    whole = omd.unpack_decisions(
        omd.intra_decision_packed(plane, 140, 4000.0, mb, 10),
        omd.ALL_SHAPES, 1920, 256)
    row0s = (64, 192)
    for r0, (stripe, above, halo) in zip(row0s, _stripes_of(plane, row0s)):
        for (bw, bh) in omd.ALL_SHAPES:
            m, c = omd.intra_decision(stripe, bw, bh, 140, 4000.0, mb, 10,
                                      above, halo)
            m2, c2 = omd.intra_decision_plain(stripe, bw, bh, 140, 4000.0,
                                              mb, 10, above, halo)
            assert torch.equal(m, m2), (bw, bh)
            assert bool(torch.isclose(c, c2, rtol=1e-5).all()), (bw, bh)
            if r0 + 64 < 256:
                assert torch.equal(m, whole[(bw, bh)][0][
                    r0 // bh:(r0 + 64) // bh]), (bw, bh)


def _k4_search_inputs10(dev, fw, fh, seed, halos=False):
    """10-bit int32 recon planes (luma, two chroma) of a [ceil8(fh), fw]
    buffer, int16 sources near them, the recon's directions (cs 2), a
    nonskip map and, for a stripe, every plane's neighbour rows."""
    H = -(-fh // 8) * 8
    full = [torch.from_numpy(_plane10((H >> s) + 4, fw >> s, seed + s)
                             .astype(np.int32)).to(dev) for s in (0, 1, 1)]
    rec = [f[2:-2].contiguous() for f in full]
    src = [(r + torch.randint(-24, 25, r.shape, device=dev)).clamp(0, 1023)
           .to(torch.int16) for r in rec]
    dirs, var = cdef.cdef_direction(rec[0], fw, fh, 2)
    rng = np.random.default_rng(seed)
    ns = torch.from_numpy(rng.random(dirs.shape) < 0.7).to(dev)
    hal = [(f[:2].contiguous(), f[-2:].contiguous()) for f in full] \
        if halos else None
    return src, rec, dirs, var, ns, hal


@pytest.mark.parametrize("grid", ["fast", "full"])
@pytest.mark.parametrize("n", [1, 3], ids=["luma", "three_planes"])
@pytest.mark.parametrize("halos", [False, True], ids=["frame", "stripe"])
def test_k4_search_16bit_matches_plain(dev, grid, n, halos):
    """K4's search on int16 sources at bit depth 10, one launch: both
    totals exactly the plain version's, at 1080p (a 1920x64 stripe with
    its neighbours' rows)."""
    ps, ss = (cdef.PRI_SET_FAST, cdef.SEC_SET_FAST) if grid == "fast" \
        else (cdef.PRI_SET, cdef.SEC_SET)
    fw, fh = (1920, 64) if halos else (1920, 1080)
    src, rec, dirs, var, ns, hal = _k4_search_inputs10(dev, fw, fh, 5,
                                                       halos)
    hal = hal[:n] if hal else None
    before = cdef.cdef_search.launches
    got = cdef.cdef_search(src[:n], rec[:n], dirs, var, ns, fw, fh, 5, 10,
                           ps, ss, halos=hal)
    assert cdef.cdef_search.launches == before + 1
    want = cdef.search_plain(src[:n], rec[:n], dirs, var, ns, fw, fh, 5, 10,
                             ps, ss, halos=hal)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) if n == 1 else torch.equal(got[1], want[1])
    assert bool((got[0] > 0).all())


def test_16bit_wrappers_refuse_other_pairings(dev):
    """A 10-bit plane reaches a 16-bit form or raises: K1 and K4's search
    take uint8 at 8 bits and int16 at 10, nothing else."""
    mb = (0.0,) * 13
    for dtype, bd in ((torch.uint8, 10), (torch.int16, 8),
                      (torch.int16, 12), (torch.int32, 10)):
        with pytest.raises(ValueError):
            omd.intra_decision(torch.zeros((64, 64), dtype=dtype,
                                           device=dev), 8, 8, 100, 1.0, mb,
                               bd)
    p16 = torch.zeros((64, 64), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):         # stripe rows of another type
        omd.intra_decision(p16, 8, 8, 100, 1.0, mb, 10,
                           torch.zeros(64, dtype=torch.uint8, device=dev),
                           torch.zeros((8, 64), dtype=torch.uint8,
                                       device=dev))
    src, rec, dirs, var, ns, _ = _k4_search_inputs10(dev, 64, 64, 1)
    for s, bd in ((src, 8), ([t.to(torch.uint8) for t in src], 10),
                  (src, 12)):
        with pytest.raises(ValueError):
            cdef.cdef_search(s, rec, dirs, var, ns, 64, 64, 5, bd)


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_k2_bd10_1080p_matches_plain(dev, chroma):
    h, w, vw, vh = (576, 960, 960, 540) if chroma else (1152, 1920, 1920,
                                                        1080)
    prm = _edge_inputs(h, w, vw, vh, chroma, 13 + chroma)
    for plane in (_plane10(h, w, 7).astype(np.int32),
                  _smooth_plane(h, w, 8, 10)):
        for lv in (8, 32, 63):
            got, p = _k2_check(dev, plane, prm, vw, vh, lv, lv, 0, 10)
            assert not torch.equal(got, p)


def test_k3_bd10_1080p_matches_plain(dev):
    plane = torch.from_numpy(_plane10(1152, 1920, 9).astype(np.int32)) \
        .to(dev)
    d, _ = _k3_check(plane, 1920, 1080, 2)
    assert len(torch.unique(d)) == 8


def test_tenbit_stream_on_the_card_equals_the_plain_stream(dev, tmp_path):
    """The 10-bit all-intra 64x64 clip coded on the card (K1's and K4's
    search's 16-bit forms, K2-K4 at bd 10) equals the CPU stream."""
    frames = []
    for i in range(2):
        y = _plane10(64, 64, i).astype(np.uint16)
        frames.append((y, (y[::2, ::2] // 2 + 200).astype(np.uint16),
                       (700 - y[1::2, 1::2] // 3).astype(np.uint16)))
    cfg = EncoderConfig(source_width=64, source_height=64, qp=40,
                        enc_mode=8, intra_period_length=0,
                        encoder_bit_depth=10,
                        pred_structure=PredStructure.LOW_DELAY_P)
    out = {}
    before = (omd.intra_decision_packed.launches, cdef.cdef_search.launches)
    for d in ("cuda", "cpu"):
        p = tmp_path / f"{d}.ivf"
        encode_ivf(frames, cfg, str(p), device=d)
        out[d] = p.read_bytes()
    assert omd.intra_decision_packed.launches > before[0]
    assert cdef.cdef_search.launches > before[1]
    assert out["cuda"] == out["cpu"]


# -- 10-bit low-delay P: the 16-bit forms of K5-K8 (me_coarse.cu,
# me_refine.cu, subpel_refine.cu, inter_select.cu)

def _pair10(kind, h, w, seed):
    """(src, ref) int16 10-bit planes: a textured plane and its fractional
    move plus noise ("textured"), flat and period-8 planes where offsets
    and candidates tie ("ties"), or blocks at 0 and 1023 against their
    complement moved by a few samples ("extremes": the largest absolute
    differences the samples allow)."""
    rng = np.random.default_rng(seed)
    if kind == "textured":
        ref = _plane10(h, w, seed).astype(np.int32)
        a = np.roll(ref, (3, -5), axis=(0, 1))
        b = np.roll(ref, (4, -5), axis=(0, 1))
        src = ((a + b + 1) // 2 + rng.integers(-8, 9, (h, w))).clip(0, 1023)
        return src.astype(np.int16), ref.astype(np.int16)
    if kind == "ties":
        yy, xx = np.mgrid[0:h, 0:w]
        ref = (300 + 80 * (xx % 8) + 20 * (yy % 8)).astype(np.int16)
        ref[:, : w // 2] = 700
        return np.roll(ref, (2, 3), axis=(0, 1)), ref
    src = _extreme_plane10(h, w, seed)
    return src, np.roll(1023 - src, (1, -2), axis=(0, 1))


def _cuda10(dev, kind, h, w, seed):
    return tuple(torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                 for p in _pair10(kind, h, w, seed))


def _unchanged(*tensors):
    """Copies of the inputs, to show after a call that the kernel left
    them as they were."""
    return [t.clone() for t in tensors]


def _k5_16_equal(src, ref, r, row0=0):
    keep = _unchanged(src, ref)
    want = bme.coarse_sb_search(src, ref, r, row0)
    before = (bme.me_coarse.calls, bme.me_coarse.launches)
    got = bme.me_coarse(src, ref, r, row0)
    assert (bme.me_coarse.calls, bme.me_coarse.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, want), (r, row0)
    assert all(torch.equal(a, b) for a, b in zip(keep, (src, ref)))
    return got


@pytest.mark.parametrize("kind", ["textured", "ties", "extremes"])
@pytest.mark.parametrize("r", [8, 12, 16, 24])
def test_k5_16bit_1080p_matches_plain(dev, kind, r):
    """K5's 16-bit form on 1152x1920 int16 planes at each reach of the
    path, one launch per call, the inputs left unmodified."""
    src, ref = _cuda10(dev, kind, 1152, 1920, r)
    assert int(src.max()) > 255
    _k5_16_equal(src, ref, r)
    if kind == "textured":
        _k5_16_equal(src, torch.roll(ref, (7 * r, -5 * r), (0, 1))
                     .contiguous(), r)


@pytest.mark.parametrize("shape", [(64, 1920), (1152, 64)],
                         ids=["one_sb_row", "one_sb_column"])
@pytest.mark.parametrize("r", [8, 24])
def test_k5_16bit_one_sb_row_and_column_match_plain(dev, shape, r):
    _k5_16_equal(*_cuda10(dev, "textured", *shape, r), r)


@pytest.mark.parametrize("row0", [64, 512, 1024])
def test_k5_16bit_stripes_match_plain(dev, row0):
    src, ref = _cuda10(dev, "textured", 1088, 1920, row0)
    stripe = src[row0:row0 + 64].contiguous()
    got = _k5_16_equal(stripe, ref, 8, row0)
    assert torch.equal(got, bme.coarse_sb_search(src, ref, 8)[
        row0 // 64:row0 // 64 + 1])


def _k6_16_equal(src, ref, coarse, shapes, row0=0):
    keep = _unchanged(src, ref, coarse)
    before = (bme.me_refine.calls, bme.me_refine.launches)
    got = bme.me_refine(src, ref, coarse, shapes, row0)
    assert (bme.me_refine.calls, bme.me_refine.launches) == (
        before[0] + 1, before[1] + 1)
    want = bme.refine_plain(src, ref, coarse, shapes, row0)
    for s in shapes:
        for g, w in zip(got[s], want[s]):
            assert torch.equal(g, w), s
    if (16, 16) in shapes:
        assert torch.equal(got["win16"], want["win16"])
    assert all(torch.equal(a, b) for a, b in zip(keep, (src, ref, coarse)))
    return got


@pytest.mark.parametrize("shapes", [bme.ME_SHAPES, ((16, 16), (64, 64))],
                         ids=["all", "path"])
@pytest.mark.parametrize("kind", ["textured", "ties", "extremes"])
def test_k6_16bit_1080p_matches_plain(dev, kind, shapes):
    """K6's 16-bit form on 1152x1920 int16 planes: the 8x8 table (all 8
    ME shapes) and the 16x16 table of 32-bit entries (the path's shapes;
    "extremes" puts 16x16 SADs far above 65,535), with K5's winners and
    with arbitrary ones, one launch per call."""
    src, ref = _cuda10(dev, kind, 1152, 1920, 3)
    rng = np.random.default_rng(4)
    for coarse in (bme.me_coarse(src, ref, 8), torch.from_numpy(
            rng.integers(-40, 41, (18, 30, 2)).astype(np.int32)).to(dev)):
        _k6_16_equal(src, ref, coarse, shapes)


@pytest.mark.parametrize("shapes", [bme.ME_SHAPES, ((16, 16), (64, 64))],
                         ids=["all", "path"])
def test_k6_16bit_sads_of_1023_against_0_match_plain(dev, shapes):
    """Samples of 1023 against 0: every offset ties, and every 8x8 SAD is
    65,472 (the fine table's uint16 limit) and every 16x16 one 261,888
    (the coarse table's 32-bit entries)."""
    src = torch.full((192, 256), 1023, dtype=torch.int16, device=dev)
    ref = torch.zeros_like(src)
    got = _k6_16_equal(src, ref, bme.me_coarse(src, ref, 8), shapes)
    for (w, h) in shapes:
        assert bool((got[(w, h)][2] == w * h * 1023).all()), (w, h)


@pytest.mark.parametrize("shape", [(64, 1920), (1152, 64)],
                         ids=["one_sb_row", "one_sb_column"])
@pytest.mark.parametrize("shapes", [bme.ME_SHAPES, ((16, 16), (64, 64))],
                         ids=["all", "path"])
def test_k6_16bit_one_sb_row_and_column_match_plain(dev, shape, shapes):
    src, ref = _cuda10(dev, "textured", *shape, 6)
    # a reference one sample past a 16-byte boundary: the clamped path
    off = torch.empty(ref.numel() + 16, dtype=torch.int16, device=dev)[
        1:1 + ref.numel()].view(ref.shape).copy_(ref)
    for r in (ref, off):
        _k6_16_equal(src, r, bme.me_coarse(src, ref, 8), shapes)


@pytest.mark.parametrize("row0", [64, 512, 1024])
def test_k6_16bit_stripes_match_plain(dev, row0):
    src, ref = _cuda10(dev, "textured", 1088, 1920, row0)
    stripe = src[row0:row0 + 64].contiguous()
    coarse = bme.me_coarse(stripe, ref, 8, row0)
    path = ((16, 16), (64, 64))
    got = _k6_16_equal(stripe, ref, coarse, path, row0)
    whole = bme.refine_plain(src, ref, bme.coarse_sb_search(src, ref, 8),
                             path)
    k = (row0 // 64) * 30
    for s in path:
        for g, w in zip(got[s], whole[s]):
            assert torch.equal(g, w[k:k + 30]), s


def _k7_16_equal(src, ref, mv_r, mv_c, row0=0):
    keep = _unchanged(src, ref, mv_r, mv_c)
    before = (bme.subpel_refine16.calls, bme.subpel_refine16.launches)
    got = bme.subpel_refine16(src, ref, mv_r, mv_c, 10, row0)
    assert (bme.subpel_refine16.calls, bme.subpel_refine16.launches) == (
        before[0] + 1, before[1] + 1)
    want = bme.subpel_plain(src, ref, mv_r, mv_c, 10, row0)
    assert got[2].dtype == want[2].dtype == torch.int16
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(torch.equal(a, b)
               for a, b in zip(keep, (src, ref, mv_r, mv_c)))
    return got


def _me16(src, ref, ny, nx):
    me = bme.frame_me(src, ref, 8, ((16, 16), (64, 64)))
    return (bi._nested_to_grid(me[(16, 16)][0], ny, nx, 4, 4),
            bi._nested_to_grid(me[(16, 16)][1], ny, nx, 4, 4), me)


@pytest.mark.parametrize("kind", ["textured", "ties", "extremes"])
def test_k7_16bit_1080p_matches_plain(dev, kind):
    """K7's 16-bit form on 1088x1920 int16 planes at bd 10, with the ME's
    MVs and with MVs past every edge: MVs and the int16 prediction
    exactly the plain version's, one launch per call."""
    src, ref = _cuda10(dev, kind, 1088, 1920, 9)
    mv_r, mv_c, _ = _me16(src, ref, 17, 30)
    got = _k7_16_equal(src, ref, mv_r, mv_c)
    assert int(got[2].max()) > 255
    if kind == "textured":
        assert bool((got[0] % 8 != 0).any())
    r, c = _edge_mvs(np.random.default_rng(9), 68, 120, 1088, 1920)
    _k7_16_equal(src, ref, r.to(dev), c.to(dev))


def test_k7_16bit_one_sb_row_matches_plain(dev):
    src, ref = _cuda10(dev, "textured", 64, 1920, 2)
    mv_r, mv_c, _ = _me16(src, ref, 1, 30)
    _k7_16_equal(src, ref, mv_r, mv_c)
    r, c = _edge_mvs(np.random.default_rng(2), 4, 120, 64, 1920)
    _k7_16_equal(src, ref, r.to(dev), c.to(dev))


@pytest.mark.parametrize("row0", [64, 512, 1024])
def test_k7_16bit_stripe_matches_plain(dev, row0):
    src, ref = _cuda10(dev, "textured", 1088, 1920, row0)
    mv_r, mv_c, _ = _me16(src, ref, 17, 30)
    whole = _k7_16_equal(src, ref, mv_r, mv_c)
    k = row0 // 16
    part = _k7_16_equal(src[row0:row0 + 64].contiguous(), ref,
                        mv_r[k:k + 4].contiguous(),
                        mv_c[k:k + 4].contiguous(), row0)
    assert torch.equal(part[2], whole[2][row0:row0 + 64])


def _k8_refs10(dev, src, refs):
    """(preds, mvq_r, mvq_c, sb_r, sb_c) of each reference through the
    16-bit K5-K7 at bd 10."""
    H, W = src.shape
    ny, nx = H // 64, W // 64
    parts = []
    for r in refs:
        mv_r, mv_c, me = _me16(src, r, ny, nx)
        a, b, p = bme.subpel_refine16(src, r, mv_r, mv_c, 10)
        parts.append((p, a, b, me[(64, 64)][0].reshape(ny, nx),
                      me[(64, 64)][1].reshape(ny, nx)))
    return tuple(torch.stack([q[i] for q in parts]).contiguous()
                 for i in range(5))


def _k8_args10(dev, kind, k, H=1088, W=1920, seed=3):
    """K8's inputs at bd 10: the kind's pair, with references moved apart
    so that each wins somewhere."""
    src, ref = _cuda10(dev, kind, H, W, seed)
    refs = [torch.roll(ref, (i, -2 * i), (0, 1)).contiguous()
            for i in range(k)]
    return (src,) + _k8_refs10(dev, src, refs)


def _k8_16_equal(args, comp=None):
    keep = _unchanged(*args[:6])
    before = (bi.inter_select.calls, bi.inter_select.launches)
    f = _assert_k8_equals_plain(args, comp)
    assert bi.inter_select.calls == before[0] + 1
    assert all(torch.equal(a, b) for a, b in zip(keep, args[:6]))
    return f


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("kind", ["textured", "extremes"])
def test_k8_16bit_1080p_matches_plain(dev, kind, k):
    """K8's 16-bit form on 1088x1920 int16 planes with 1-3 references at
    bd 10: every selection field equal, every cost of every shape within
    the gate, one launch per call."""
    args = _k8_args10(dev, kind, k)
    f = _k8_16_equal(args + (60, 900.0 * 16, 10))
    if k == 3 and kind == "textured":
        assert len(torch.unique(f["sel"])) > 1


def test_k8_16bit_one_sb_row_matches_plain(dev):
    _k8_16_equal(_k8_args10(dev, "textured", 2, 64, 1920, 7)
                 + (160, 2500.0 * 16, 10))


def test_k8_16bit_compound_row_matches_plain(dev):
    """K8's 16-bit form with a 16-bit compound row (the plain compound
    search's int16 prediction) at 1080p."""
    # two 10-bit patterns, the source their cross-fade, each moved
    H, W = 1088, 1920
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:H, 0:W]
    pats = [(440 + 240 * np.sin(xx / (9 + 4 * i) + i)
             + 160 * np.cos(yy / (7 + 3 * i))
             + rng.integers(-48, 49, (H, W))).clip(0, 1023).astype(np.int32)
            for i in range(2)]
    moved = [np.roll(p, sh, axis=(0, 1))
             for p, sh in zip(pats, ((2, -3), (-6, 5)))]
    src = ((moved[0] + moved[1] + 1) // 2 + rng.integers(-8, 9, (H, W)))
    src = torch.from_numpy(src.clip(0, 1023).astype(np.int16)).to(dev)
    refs = torch.stack([torch.from_numpy(p.astype(np.int16)) for p in pats]) \
        .to(dev).contiguous()
    preds, mr, mc, sr, sc = _k8_refs10(dev, src, list(refs))
    comp = bi.compound_joint_plain(src, refs, preds, mr, mc, sr, sc,
                                   (False, True), (-1, 1), 60, 10)
    assert comp["pred"].dtype == torch.int16
    f = _k8_16_equal((src, preds, mr, mc, sr, sc, 60, 900.0 * 16, 10), comp)
    assert bool((f["sel"] == 2).any())


def test_16bit_inter_wrappers_refuse_other_pairings(dev):
    """A 10-bit plane reaches a 16-bit form or raises: K5 and K6 take one
    sample type for both planes, uint8 or int16; K7, K8 and K9 uint8 at
    bd 8 and int16 at bd 10."""
    z8 = torch.zeros((128, 128), dtype=torch.uint8, device=dev)
    z16 = z8.to(torch.int16)
    mv = torch.zeros((8, 8), dtype=torch.int32, device=dev)
    for a, b in ((z16, z8), (z8, z16), (z16.to(torch.int32), z16)):
        with pytest.raises(ValueError):
            bme.me_coarse(a, b)
        with pytest.raises(ValueError):
            bme.me_refine(a, b, torch.zeros((2, 2, 2), dtype=torch.int32,
                                            device=dev))
    for p, bd in ((z8, 10), (z16, 8), (z16, 12), (z8, 12)):
        with pytest.raises(ValueError):
            bme.subpel_refine16(p, p, mv, mv, bd)
    mvk = torch.zeros((1, 8, 8), dtype=torch.int32, device=dev)
    sbk = torch.zeros((1, 2, 2), dtype=torch.int32, device=dev)
    for s, p, bd in ((z8, z8[None], 10), (z16, z16[None], 8),
                     (z16, z8[None], 10), (z16, z16[None], 12)):
        with pytest.raises(ValueError):
            bi.inter_select(s, p.contiguous(), mvk, mvk, sbk, sbk, 60, 1.0,
                            bd)
    comp = {k: torch.zeros((8, 8), dtype=torch.int32, device=dev)
            for k in bi.COMP_KEYS}
    comp["pred"] = z8
    with pytest.raises(ValueError):          # an 8-bit compound row
        bi.inter_select(z16, z16[None].contiguous(), mvk, mvk, sbk, sbk, 60,
                        1.0, 10, comp=comp)
    for s, p, bd in ((z16, z16, 8), (z8, z8, 10), (z16, z16, 12)):
        two = torch.stack([p, p]).contiguous()
        with pytest.raises(ValueError):
            bi.compound_joint(s, two, two, mvk.repeat(2, 1, 1),
                              mvk.repeat(2, 1, 1), sbk.repeat(2, 1, 1),
                              sbk.repeat(2, 1, 1), (False, True), (-1, 1),
                              60, bd)


def test_tenbit_ipp_stream_on_the_card_equals_the_plain_stream(dev,
                                                               tmp_path):
    """A 10-bit low-delay P clip (192x128, a key frame and three P frames)
    coded on the card through the 16-bit K1 and K5-K8 equals the CPU
    stream."""
    base = _plane10(160, 224, 4).astype(np.uint16)
    frames = []
    for i in range(4):
        y = np.ascontiguousarray(np.roll(base, (i, 2 * i), axis=(0, 1))
                                 [:128, :192])
        frames.append((y, (y[::2, ::2] // 2 + 200).astype(np.uint16),
                       (700 - y[1::2, 1::2] // 3).astype(np.uint16)))
    cfg = EncoderConfig(source_width=192, source_height=128, qp=40,
                        enc_mode=8, intra_period_length=-1,
                        encoder_bit_depth=10,
                        pred_structure=PredStructure.LOW_DELAY_P)
    fns = (bme.me_coarse, bme.me_refine, bme.subpel_refine16,
           bi.inter_select)
    out = {}
    for d in ("cuda", "cpu"):
        before = [f.launches for f in fns]
        p = tmp_path / f"{d}.ivf"
        encode_ivf(frames, cfg, str(p), device=d)
        out[d] = p.read_bytes()
        if d == "cuda":
            assert all(f.launches > b for f, b in zip(fns, before))
    assert out["cuda"] == out["cpu"]


# -- 10-bit random access: K9's 16-bit form (compound_joint.cu), K10
# redesigned in both sample types (block_var16.cu), K5/K6 16-bit at TPL's
# geometry

def _k9_16_equal(args, bwd, rel, qindex=60):
    """K9's 16-bit form against the plain version at bd 10: every output
    equal, one launch per call, the inputs left as they were."""
    keep = _unchanged(*args)
    before = (bi.compound_joint.calls, bi.compound_joint.launches)
    got = bi.compound_joint(*args, bwd, rel, qindex, 10)
    assert (bi.compound_joint.calls, bi.compound_joint.launches) == (
        before[0] + 1, before[1] + 1)
    want = bi.compound_joint_plain(*args, bwd, rel, qindex, 10)
    assert got["pred"].dtype == want["pred"].dtype == torch.int16
    for key in bi.COMP_KEYS:
        assert torch.equal(got[key], want[key]), key
    assert all(torch.equal(a, b) for a, b in zip(keep, args))
    return got


@pytest.mark.parametrize("kind", ["textured", "ties", "extremes"])
def test_k9_16bit_1080p_matches_plain(dev, kind):
    """K9's 16-bit form on the random-access path's 1920x1152 int16
    planes: a textured pair, flat and period-8 planes where offsets and
    the three candidates tie, and planes of 0 and 1023 (the largest
    absolute differences and averages); the textured case's compound row
    then feeds K8's 16-bit form."""
    src, ref = _pair10(kind, 1152, 1920, 12)
    refs = [ref, np.roll(ref, (8, -8) if kind == "ties" else (-6, 5),
                         axis=(0, 1))]
    args = _k9_inputs(dev, src, refs, bd=10)
    got = _k9_16_equal(args, (False, True), (-1, 1))
    if kind == "textured":
        assert int(got["pred"].max()) > 255
        refined = (got["mv1_r"] != args[4][1]) | (got["mv_r"] != args[4][0])
        assert bool(refined.any())
        _k8_16_equal((args[0],) + args[2:] + (60, 900.0 * 16, 10), got)


@pytest.mark.parametrize("size", [(192, 256), (64, 1920)],
                         ids=["frame", "one_sb_row"])
def test_k9_16bit_windows_clipped_at_every_edge_match_plain(dev, size):
    """Mirrored seeds that put each arm's window past every edge of a
    10-bit plane (the origin clips to the pad, the reads clamp)."""
    H, W = size
    src, ref = _pair10("textured", H, W, 9)
    refs = [ref, np.roll(ref, (3, 5), axis=(0, 1))]
    for seed in range(3):
        args = _k9_inputs(dev, src, refs, "edges", seed, bd=10)
        _k9_16_equal(args, (False, True), (-2, 3))
        _k9_16_equal(args, (True, False), (1, -1))


@pytest.mark.parametrize("mask", [m for m in range(1, 7)],
                         ids=lambda m: "".join("B" if (m >> k) & 1 else "F"
                                               for k in range(3)))
def test_k9_16bit_three_references_each_backward_mask_match_plain(dev,
                                                                   mask):
    src, ref = _pair10("textured", 192, 256, mask)
    refs = [ref, np.roll(ref, (2, -3), axis=(0, 1)),
            np.roll(ref, (-5, 4), axis=(0, 1))]
    bwd = tuple(bool((mask >> k) & 1) for k in range(3))
    rel = tuple((k + 1) * (1 if b else -1) for k, b in enumerate(bwd))
    _k9_16_equal(_k9_inputs(dev, src, refs, bd=10), bwd, rel)


def test_k9_16bit_refuses_planes_off_16_byte_boundaries(dev):
    src, ref = _pair10("textured", 64, 128, 0)
    args = _k9_inputs(dev, src, [ref, np.roll(ref, 2, axis=1)], bd=10)
    shifted = torch.empty(args[0].numel() + 8, dtype=torch.int16,
                          device=dev)[1:1 + args[0].numel()].view(
                              args[0].shape)
    shifted.copy_(args[0])
    with pytest.raises(ValueError):
        bi.compound_joint(shifted, *args[1:], (False, True), (-1, 1), 60,
                          10)


def _k10_window(dev, dt, n, h, w, seed, kind="textured"):
    """n planes of [h, w] on the card: textured 10-bit planes as int16, or
    as uint8 their top 8 bits; ``kind`` "extremes": blocks at both ends
    of the range."""
    planes = [_extreme_plane10(h, w, seed + k) if kind == "extremes"
              else _plane10(h, w, seed + k) for k in range(n)]
    a = np.stack(planes).astype(np.int32)
    if dt == torch.uint8:
        a = np.where(a == 1023, 255, a >> 2)
    return torch.from_numpy(a).to(dt).to(dev).contiguous()


def _k10_equal(x):
    keep = _unchanged(x)
    before = (tpl.block_var16.calls, tpl.block_var16.launches)
    got = tpl.block_var16(x)
    assert (tpl.block_var16.calls, tpl.block_var16.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, tpl.block_var16_plain(x))
    assert torch.equal(keep[0], x)
    return got


@pytest.mark.parametrize("n", [1, 2, 17])
@pytest.mark.parametrize("dt", [torch.uint8, torch.int16],
                         ids=["8bit", "16bit"])
def test_k10_window_at_the_tpl_geometry_matches_plain(dev, dt, n):
    """K10 on one 960x576 plane and on windows of 2 and 17 planes, one
    launch for the window, bit-equal to the plain version."""
    x = _k10_window(dev, dt, n, 576, 960, n)
    got = _k10_equal(x if n > 1 else x[0])
    assert got.shape == ((n,) if n > 1 else ()) + (36, 60)


@pytest.mark.parametrize("size", [(16, 16), (48, 80), (304, 432),
                                  (576, 976)])
@pytest.mark.parametrize("dt", [torch.uint8, torch.int16],
                         ids=["8bit", "16bit"])
def test_k10_sizes_off_the_cta_strip_match_plain(dev, dt, size):
    """Widths that are multiples of 16 but not of the 256-column strip of
    a CTA (its last run ragged), and one block."""
    _k10_equal(_k10_window(dev, dt, 3, *size, 5))


@pytest.mark.parametrize("dt", [torch.uint8, torch.int16],
                         ids=["8bit", "16bit"])
def test_k10_extremes_match_plain(dev, dt):
    """Blocks of samples at both ends of the range (0 and 1023, or 0 and
    255) and flat blocks at each end (zero variance)."""
    x = _k10_window(dev, dt, 4, 576, 960, 7, "extremes")
    x[1] = 0
    x[2] = 1023 if dt == torch.int16 else 255
    got = _k10_equal(x)
    assert bool((got[1] == 0).all()) and bool((got[2] == 0).all())


def test_k9_k10_refuse_other_pairings(dev):
    """K9 takes uint8 at bd 8 and int16 at bd 10, refs of the source's
    type; K10 contiguous uint8 or int16 [H, W] or [n, H, W] of whole
    16x16 blocks on a 16-byte boundary; anything else raises."""
    src, ref = _pair10("textured", 64, 128, 1)
    args = _k9_inputs(dev, src, [ref, np.roll(ref, 2, axis=1)], bd=10)
    for bd in (8, 12):
        with pytest.raises(ValueError):
            bi.compound_joint(*args, (False, True), (-1, 1), 60, bd)
    with pytest.raises(ValueError):           # 8-bit refs beside int16
        bi.compound_joint(args[0], args[1].to(torch.uint8), *args[2:],
                          (False, True), (-1, 1), 60, 10)
    z = torch.zeros((2, 64, 64), dtype=torch.int16, device=dev)
    for bad in (z.to(torch.int32), z.float(), z[None], z[:, :48, :40],
                z.transpose(1, 2), z[0, :, :8]):
        with pytest.raises(ValueError):
            tpl.block_var16(bad)
    flat = torch.zeros(64 * 64 + 8, dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):           # off a 16-byte boundary
        tpl.block_var16(flat[1:1 + 64 * 64].view(64, 64))


@pytest.mark.parametrize("kind", ["textured", "extremes"])
def test_k5_k6_16bit_at_the_tpl_geometry_match_plain(dev, kind):
    """TPL's statistics at 10 bits: K5 and K6's 16-bit forms on 960x576
    int16 planes with the single shape 16x16, one launch each."""
    src, ref = _cuda10(dev, kind, 576, 960, 4)
    _k5_16_equal(src, ref, bme.COARSE_R)
    coarse = bme.coarse_sb_search(src, ref)
    _k6_16_equal(src, ref, coarse, ((16, 16),))
    got = bme.frame_me(src, ref, shapes=((16, 16),))
    want = bme.refine_plain(src, ref, coarse, ((16, 16),))
    for g, w in zip(got[(16, 16)], want[(16, 16)]):
        assert torch.equal(g, w)


def test_tenbit_ra_stream_on_the_card_equals_the_plain_stream(dev,
                                                              tmp_path):
    """A 10-bit random-access clip (192x128x5, hierarchical_levels 2: MCTF,
    TPL, compound, show_existing) coded on the card through the 16-bit
    forms of K1 and K5-K10 equals the CPU stream."""
    base = _plane10(160, 224, 8).astype(np.uint16)
    frames = []
    for i in range(5):
        y = np.ascontiguousarray(np.roll(base, (i, 2 * i), axis=(0, 1))
                                 [:128, :192])
        frames.append((y, (y[::2, ::2] // 2 + 200).astype(np.uint16),
                       (700 - y[1::2, 1::2] // 3).astype(np.uint16)))
    cfg = EncoderConfig(source_width=192, source_height=128, qp=40,
                        enc_mode=8, intra_period_length=-1,
                        hierarchical_levels=2, encoder_bit_depth=10)
    fns = (bme.me_coarse, bme.me_refine, bme.subpel_refine16,
           bi.inter_select, bi.compound_joint, tpl.block_var16)
    out = {}
    for d in ("cuda", "cpu"):
        before = [f.launches for f in fns]
        p = tmp_path / f"{d}.ivf"
        encode_ivf(frames, cfg, str(p), device=d)
        out[d] = p.read_bytes()
        if d == "cuda":
            assert all(f.launches > b for f, b in zip(fns, before))
    assert out["cuda"] == out["cpu"]


# -- K4's per-fb forms (cdef_bits > 0): the search's totals per 64x64
# filter block and the apply with each filter block's preset index

def _k4_fb_inputs(dev, w, h, bd, seed):
    """Recon planes (int32) of a [ceil8(h), ceil8(w)] buffer, sources of
    the sample type near them, the recon's directions and a nonskip
    map."""
    fw, fh = -(-w // 8) * 8, -(-h // 8) * 8
    if bd == 8:
        rec = _k4_planes(dev, [(fh, fw), (fh // 2, fw // 2),
                               (fh // 2, fw // 2)], seed)
        src = [(r + torch.randint(-9, 10, r.shape, device=dev))
               .clamp(0, 255).to(torch.uint8) for r in rec]
    else:
        rec = [torch.from_numpy(_plane10(fh >> s, fw >> s, seed + s)
                                .astype(np.int32)).to(dev) for s in (0, 1, 1)]
        src = [(r + torch.randint(-36, 37, r.shape, device=dev))
               .clamp(0, 1023).to(torch.int16) for r in rec]
    dirs, var = cdef.cdef_direction(rec[0], fw, fh, bd - 8)
    ns = _k4_ns(dev, fw, fh, seed, 0.7)
    return src, rec, dirs, var, ns, fw, fh


@pytest.mark.parametrize("bd", [8, 10], ids=["uint8", "int16"])
@pytest.mark.parametrize("size", [(1920, 1080), (200, 136), (72, 40)],
                         ids=["1080p", "200x136", "72x40"])
def test_k4_search_fb_matches_plain(dev, bd, size):
    """K4's per-fb search, one launch for the three planes over the full
    8 x 4 grid: every filter block's totals exactly the plain version's
    (int64 [32, nvfb, nhfb] per group), and their sum the frame-level
    search's."""
    src, rec, dirs, var, ns, fw, fh = _k4_fb_inputs(dev, *size, bd, 5)
    before = (cdef.cdef_search_fb.calls, cdef.cdef_search_fb.launches)
    got = cdef.cdef_search_fb(src, rec, dirs, var, ns, fw, fh, 5, bd)
    assert (cdef.cdef_search_fb.calls, cdef.cdef_search_fb.launches) == (
        before[0] + 1, before[1] + 1)
    want = cdef.cdef_search_errs_fb_plain(src, rec, dirs, var, ns, fw, fh, 5,
                                          bd)
    frame = cdef.cdef_search(src, rec, dirs, var, ns, fw, fh, 5, bd)
    for g, w, f in zip(got, want, frame):
        assert g.dtype == torch.int64
        assert g.shape == (32, -(-fh // 64), -(-fw // 64))
        assert torch.equal(g, w)
        assert torch.equal(g.sum((1, 2)).reshape(8, 4), f)
    luma = cdef.cdef_search_fb(src[:1], rec[:1], dirs, var, ns, fw, fh, 5,
                               bd)
    assert luma[1] is None and torch.equal(luma[0], got[0])


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("bits", [1, 2, 3])
@pytest.mark.parametrize("size", [(1920, 1080), (200, 136)],
                         ids=["1080p", "200x136"])
def test_k4_apply_multi_matches_plain(dev, bd, bits, size):
    """K4's per-fb apply, one launch for the three planes, on random index
    grids into random lists of 2^bits presets: exactly the plain version,
    the input untouched."""
    _, rec, dirs, var, ns, fw, fh = _k4_fb_inputs(dev, *size, bd, bits)
    rng = np.random.default_rng(bits * 10 + bd)
    nb = 1 << bits
    for trial in range(2):
        ys = tuple(int(v) for v in rng.integers(0, 64, nb))
        us = tuple(int(v) for v in rng.integers(0, 64, nb))
        if trial:
            ys, us = (0,) + ys[1:], (0,) + us[1:]   # a preset that copies
        idx = rng.integers(0, nb, (-(-fh // 64), -(-fw // 64)))
        keep = [p.clone() for p in rec]
        before = cdef.cdef_apply_multi.launches
        got = cdef.cdef_apply_multi(rec, ns, dirs, var, ys, us, idx, 4, fw,
                                    fh, bd)
        assert cdef.cdef_apply_multi.launches == before + 1
        want = cdef.cdef_frame_multi_plain(rec, ns, dirs, var, ys, us, idx,
                                           4, fw, fh, bd)
        for g, w, p, k in zip(got, want, rec, keep):
            assert torch.equal(g, w), (ys, us)
            assert torch.equal(p, k) and g.data_ptr() != p.data_ptr()


def test_k4_apply_multi_one_preset_is_the_frame_level_apply(dev):
    _, rec, dirs, var, ns, fw, fh = _k4_fb_inputs(dev, 1920, 1080, 8, 7)
    idx = np.zeros((-(-fh // 64), -(-fw // 64)), np.int32)
    for ys, us in ((37, 14), (0, 6), (61, 0)):
        got = cdef.cdef_apply_multi(rec, ns, dirs, var, (ys,), (us,), idx, 5,
                                    fw, fh, 8)
        want = cdef.cdef_apply(rec, ns, dirs, var, ys, us, 5, fw, fh, 8)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_k4_per_fb_forms_refuse_bad_inputs(dev):
    _, rec, dirs, var, ns, fw, fh = _k4_fb_inputs(dev, 200, 136, 8, 9)
    good = np.zeros((3, 4), np.int32)
    for ys, us, idx in (((1, 2), (3, 4), good + 2),      # past the lists
                        ((1, 2), (3,), good),             # lengths differ
                        (tuple(range(9)), tuple(range(9)), good),
                        ((1,), (1,), np.zeros((2, 4), np.int32))):
        with pytest.raises(ValueError):
            cdef.cdef_apply_multi(rec, ns, dirs, var, ys, us, idx, 4, fw, fh,
                                  8)
    src = [r.to(torch.int16) for r in rec]            # 8 bits take uint8
    with pytest.raises(ValueError):
        cdef.cdef_search_fb(src, rec, dirs, var, ns, fw, fh, 4, 8)


def _cuda_records(fn, tries=3):
    """fn()'s result and the names of the device records (kernels and
    copies) torch.profiler took during it.  The profiler now and then
    delivers no device record at all for a window that launched a kernel
    (twice in about 30 windows on an H100); such a window is run
    again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return out, names


@pytest.mark.parametrize("bd", [8, 10])
def test_k4_apply_multi_chroma_halves_take_their_own_presets(dev, bd):
    """A chroma tile's 64 columns span two filter blocks: grids whose
    columns alternate between two presets (one of them (0, 0), or both
    filtering) give every chroma tile halves of their own, in both
    orders; exactly the plain version."""
    _, rec, dirs, var, ns, fw, fh = _k4_fb_inputs(dev, 200, 136, bd, 11)
    nvfb, nhfb = -(-fh // 64), -(-fw // 64)
    cols = np.arange(nhfb) % 2
    for ys, us in (((37, 0), (14, 0)), ((0, 61), (0, 22)),
                   ((9, 50), (33, 7))):
        for flip in (0, 1):
            idx = np.broadcast_to(cols ^ flip, (nvfb, nhfb)).copy()
            got = cdef.cdef_apply_multi(rec, ns, dirs, var, ys, us, idx, 5,
                                        fw, fh, bd)
            want = cdef.cdef_frame_multi_plain(rec, ns, dirs, var, ys, us,
                                               idx, 5, fw, fh, bd)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (ys, us, flip)
            assert not torch.equal(got[1], rec[1])


@pytest.mark.parametrize("bd", [8, 10])
def test_k4_apply_multi_every_block_at_zero_copies(dev, bd):
    """Every filter block at preset (0, 0), with lists that hold no other
    and with lists whose other presets no block takes: the input, as the
    plain version gives it."""
    _, rec, dirs, var, ns, fw, fh = _k4_fb_inputs(dev, 1920, 1080, bd, 15)
    idx = np.zeros((-(-fh // 64), -(-fw // 64)), np.int32)
    for ys, us in (((0,), (0,)), ((0, 37), (0, 14)), ((0, 0, 9, 63),
                                                      (0, 5, 0, 40))):
        got = cdef.cdef_apply_multi(rec, ns, dirs, var, ys, us, idx, 5, fw,
                                    fh, bd)
        want = cdef.cdef_frame_multi_plain(rec, ns, dirs, var, ys, us, idx,
                                           5, fw, fh, bd)
        for g, w, p in zip(got, want, rec):
            assert torch.equal(g, w) and torch.equal(g, p)


def test_k4_apply_multi_one_kernel_and_no_copy_at_1080p(dev):
    """One per-fb apply call on a 1080p grid (17 x 30 filter blocks, 8
    presets) records one kernel, the by-value form, and no copy: the grid
    travels in the launch's parameters."""
    _, rec, dirs, var, ns, fw, fh = _k4_fb_inputs(dev, 1920, 1080, 8, 17)
    rng = np.random.default_rng(17)
    ys = tuple(int(v) for v in rng.integers(1, 64, 8))
    us = tuple(int(v) for v in rng.integers(1, 64, 8))
    idx = rng.integers(0, 8, (17, 30)).astype(np.int32)
    cdef.cdef_apply_multi(rec, ns, dirs, var, ys, us, idx, 5, fw, fh, 8)
    got, names = _cuda_records(lambda: cdef.cdef_apply_multi(
        rec, ns, dirs, var, ys, us, idx, 5, fw, fh, 8))
    assert len(names) == 1 and "cdef_apply_kernel<1>" in names[0], names
    want = cdef.cdef_frame_multi_plain(rec, ns, dirs, var, ys, us, idx, 5,
                                       fw, fh, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("size,form", [
    ((8192, 4352), "cdef_apply_kernel<1>"),
    ((8256, 4352), "cdef_apply_kernel<2>")],
    ids=["capacity", "past_capacity"])
def test_k4_apply_multi_grid_at_the_by_value_capacity(dev, size, form):
    """The by-value grid holds the 128 x 68 filter blocks of AV1's largest
    level-6.3 picture (8192 x 4352), the kernel's capacity (it refuses a
    larger by-value grid); one column of blocks more takes the
    device-memory form.  Both exactly the plain version, one launch
    each."""
    assert cdef.FB_GRID_BLOCKS == 128 * 68
    _, rec, dirs, var, ns, fw, fh = _k4_fb_inputs(dev, *size, 8, 19)
    nvfb, nhfb = -(-fh // 64), -(-fw // 64)
    assert (nvfb * nhfb <= cdef.FB_GRID_BLOCKS) == form.endswith("<1>")
    rng = np.random.default_rng(19)
    ys = tuple(int(v) for v in rng.integers(0, 64, 8))
    us = tuple(int(v) for v in rng.integers(0, 64, 8))
    idx = rng.integers(0, 8, (nvfb, nhfb)).astype(np.int32)
    got, names = _cuda_records(lambda: cdef.cdef_apply_multi(
        rec, ns, dirs, var, ys, us, idx, 5, fw, fh, 8))
    applies = [n for n in names if "cdef_apply" in n]
    assert len(applies) == 1 and form in applies[0], names
    want = cdef.cdef_frame_multi_plain(rec, ns, dirs, var, ys, us, idx, 5,
                                       fw, fh, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("denom", [9, 16])
def test_k1_k3_k4_at_superres_widths_match_plain(dev, denom):
    """K1, K3 and K4's frame-level search (fast and full grids) and apply
    at the widths super-resolution codes a 1080p frame at: 1707 of 1920
    in a 1728-wide buffer (denominator 9), 960 (16); luma and chroma, one
    launch a call, K3 and K4 exactly equal to their plain versions, K1's
    modes equal and costs within rtol 1e-5 on every block of every
    shape (chip_smoke.superres_kernel_checks)."""
    import chip_smoke

    frame = chip_smoke.synth_clip(1920, 1080, 1)[0]
    planes, fw, aw, ah, bw, bh = chip_smoke.superres_planes(frame, denom)
    assert (fw, bw) == ((1707, 1728) if denom == 9 else (960, 960))
    assert planes[1].shape == (bh // 2, bw // 2)
    out = chip_smoke.superres_kernel_checks(dev, frame, denom)
    assert set(out) == {"intra_decision", "cdef_direction", "cdef_search",
                        "cdef_apply"}
