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
    before = bme.me_coarse.launches
    got = bme.me_coarse(src, ref, r)
    assert torch.equal(got, bme.coarse_sb_search(src, ref, r))
    assert bme.me_coarse.launches == before + 1


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
            bme.subpel_refine16.launches) == tuple(b + 1 for b in before)
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
