"""Per-64x64 CDEF strength presets (cdef_bits > 0) and the global-motion
fit of presets 5-6 on the CPU, against the JAX package's host numpy.

* ``cdef_search_errs_fb_plain`` (K4's per-fb search, plain version) sums
  every filter block's squared errors exactly in int64: it must equal the
  float64 sums of the squared errors of the JAX filter (``_PlaneCtx`` of
  the JAX package, the same filtered planes as its cdef_search_errs_fb)
  exactly, and the JAX float32 maps within float32 rounding.
* ``pick_cdef_presets`` on the port's exact maps must return the JAX picks
  on its float32 maps; every test prints the margins of the picks (the
  smallest relative gap between the chosen and the runner-up cost for the
  bits, the lists and each filter block's index).
* ``cdef_frame_multi_plain`` (K4's per-fb apply, plain version) must equal
  the JAX ``cdef_frame_multi`` exactly for random index grids and lists.
* The port's copy of ``estimate_rotzoom`` must return the JAX parameters.
Inputs come from a seeded numpy generator, at 8 and 10 bits.
"""
import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import cdef as jcdef
from svt_av1_tpu.ops import rdoq as jrdoq
from svt_av1_tpu.pipeline import global_motion as jgm
from svt_av1_tpu_torch.ops import cdef
from svt_av1_tpu_torch.pipeline import global_motion


def _frame(rng, w, h, bd, noise, skip_share=0.3):
    """Source, recon (source plus noise), skips and the mode-info size
    (mi_rows, mi_cols) of a frame of ``w`` x ``h`` (both multiples of 8,
    as the codec's)."""
    mx = (1 << bd) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    base = (mx / 2 + mx / 3 * np.sin(xx / 13.0) * np.cos(yy / 17.0))
    src = [np.clip(base + rng.normal(0, mx / 40, base.shape), 0, mx)]
    src += [np.clip(mx / 2 + rng.normal(0, mx / 20, (h // 2, w // 2)), 0, mx)
            for _ in range(2)]
    src = [s.astype(np.int32) for s in src]
    scale = 1 << (bd - 8)
    rec = [np.clip(s + rng.integers(-noise * scale, noise * scale + 1,
                                    s.shape), 0, mx).astype(np.int32)
           for s in src]
    mi_r, mi_c = h // 4, w // 4
    skips = (rng.random((mi_r, mi_c)) < skip_share).astype(np.int32)
    return src, rec, skips, mi_r, mi_c


def _jax_sq_sums(src, rec, dirs, var, nonskip, fw, fh, damping, bd):
    """The JAX search's squared errors (its _PlaneCtx filter over the same
    combinations, masks and padding as cdef_search_errs_fb), summed per
    filter block in int64: [32, nvfb, nhfb] for luma and chroma."""
    cs = max(bd - 8, 0)
    nvfb, nhfb = (fh + 63) // 64, (fw + 63) // 64
    outs = []
    for group in ((0,), (1, 2)):
        acc = 0
        for pli in group:
            bs, sub = (8, 0) if pli == 0 else (4, 1)
            fbpx, pw, ph = 64 >> sub, fw >> sub, fh >> sub
            padded = jcdef.pad_very_large(rec[pli], pw, ph, bs, np)
            keep = np.repeat(np.repeat(nonskip, bs, 0), bs, 1)
            H, Wd = padded.shape[0] - 4, padded.shape[1] - 4
            keep = keep & np.pad(np.ones((ph, pw), bool),
                                 ((0, H - ph), (0, Wd - pw)))
            s = np.zeros((H, Wd), np.int64)
            s[:ph, :pw] = src[pli][:ph, :pw]
            ctx = {True: jcdef._PlaneCtx(padded, dirs, bs, np),
                   False: jcdef._PlaneCtx(padded, np.zeros_like(dirs), bs,
                                          np)}
            dmp = damping + cs - (0 if pli == 0 else 1)
            rows = []
            for pri in cdef.PRI_SET:
                p = pri << cs
                pri_map = np.repeat(np.repeat(
                    jcdef._adjust_strength_xp(p, var, np), bs, 0), bs, 1) \
                    if pli == 0 else np.full((H, Wd), p, np.int32)
                for sec in cdef.SEC_SET:
                    s_ = (sec + (sec == 3)) << cs
                    filt = ctx[bool(p)].x if p == 0 and s_ == 0 else \
                        ctx[bool(p)].run(pri_map, s_, dmp, cs)
                    d = np.where(keep, filt.astype(np.int64) - s, 0)
                    sq = np.pad(d * d, ((0, nvfb * fbpx - H),
                                        (0, nhfb * fbpx - Wd)))
                    rows.append(sq.reshape(nvfb, fbpx, nhfb, fbpx)
                                .sum((1, 3)))
            acc = acc + np.stack(rows)
        outs.append(acc)
    return outs


def _gap(values, chosen):
    """Relative gap between values[chosen] and the smallest value above
    it (inf when none is larger)."""
    v = np.asarray(values, np.float64).ravel()
    above = v[v > v[chosen]]
    return float((above.min() - v[chosen]) / max(v[chosen], 1.0)) \
        if above.size else float("inf")


def pick_margins(my, muv, eligible, lambda_sse):
    """The margins of pick_cdef_presets's choices on maps [32, nvfb, nhfb]:
    (bits, lists, index) = the smallest relative gap between the chosen
    and the runner-up cost over cdef_bits 0-3, over every greedy step of
    the chosen bits' list search, and over the eligible filter blocks'
    index picks."""
    nc = 32
    el = np.asarray(eligible, bool)
    my = np.asarray(my, np.float64).reshape(nc, -1).T[el.ravel()]
    muv = np.asarray(muv, np.float64).reshape(nc, -1).T[el.ravel()]
    costs, runs = [], []
    for bits in range(4):
        nb = 1 << bits
        steps = []
        lev_y = np.zeros(nb, np.int64)
        lev_uv = np.zeros(nb, np.int64)

        def one(i):
            if i > 0:
                cur = np.min(my[:, lev_y[:i]] + muv[:, lev_uv[:i]], axis=1)
            else:
                cur = np.full(my.shape[0], np.inf)
            tot = np.minimum(cur[:, None, None],
                             my[:, :, None] + muv[:, None, :]).sum(0)
            j = int(np.argmin(tot))
            steps.append(_gap(tot, j))
            lev_y[i], lev_uv[i] = j // nc, j % nc
            return float(tot.ravel()[j])

        for i in range(nb):
            tot = one(i)
        for _ in range(4 * nb):
            lev_y[:-1] = lev_y[1:]
            lev_uv[:-1] = lev_uv[1:]
            tot = one(nb - 1)
        total_bits = my.shape[0] * bits + nb * cdef.CDEF_STRENGTH_BITS * 2
        costs.append(((512 * total_bits * lambda_sse + 256) >> 9)
                     + ((int(tot) * 16) << 7))
        runs.append((min(steps), lev_y.copy(), lev_uv.copy()))
    b = int(np.argmin(costs))
    sel = my[:, runs[b][1]] + muv[:, runs[b][2]]
    idx_gap = min((_gap(row, int(np.argmin(row))) for row in sel),
                  default=float("inf"))
    return _gap(costs, b), runs[b][0], idx_gap


def _maps(rng, w, h, bd, noise):
    src, rec, skips, mi_r, mi_c = _frame(rng, w, h, bd, noise)
    fw, fh = mi_c * 4, mi_r * 4
    ns = jcdef.nonskip_grid(skips, mi_r, mi_c)
    dirs, var = jcdef.find_dir_grid(jcdef._units_of(
        jcdef.pad_very_large(rec[0], fw, fh, 8, np), fw, fh, 8, np),
        bd - 8, np)
    damping = 3 + (bd - 8) // 2
    jy, juv = jcdef.cdef_search_errs_fb(src, rec, dirs, var, ns, fw, fh,
                                        damping, bd)
    dt = torch.uint8 if bd == 8 else torch.int16
    py, puv = cdef.cdef_search_errs_fb_plain(
        [torch.from_numpy(s).to(dt) for s in src],
        [torch.from_numpy(r) for r in rec], torch.from_numpy(dirs),
        torch.from_numpy(var), torch.from_numpy(ns), fw, fh, damping, bd)
    return dict(src=src, rec=rec, ns=ns, dirs=dirs, var=var, fw=fw, fh=fh,
                damping=damping, jax=(jy, juv), port=(py.numpy(),
                                                      puv.numpy()))


CASES = [(8, 200, 136, 6), (8, 128, 64, 24), (10, 136, 72, 6),
         (10, 192, 128, 20)]
IDS = [f"bd{bd}_{w}x{h}_noise{n}" for bd, w, h, n in CASES]


@pytest.mark.parametrize("bd, w, h, noise", CASES, ids=IDS)
def test_search_fb_plain_is_the_exact_sum_of_the_jax_squared_errors(
        bd, w, h, noise):
    m = _maps(np.random.default_rng(bd * 1000 + w), w, h, bd, noise)
    want = _jax_sq_sums(m["src"], m["rec"], m["dirs"], m["var"], m["ns"],
                        m["fw"], m["fh"], m["damping"], bd)
    for got, exact, f32 in zip(m["port"], want, m["jax"]):
        assert got.dtype == np.int64 and got.shape == (32, (m["fh"] + 63)
                                                       // 64,
                                                       (m["fw"] + 63) // 64)
        np.testing.assert_array_equal(got, exact)
        # float32 sums of up to 4096 terms: a few units in the last place
        np.testing.assert_allclose(got, f32, rtol=2 ** -20, atol=0)


@pytest.mark.parametrize("bd, w, h, noise", CASES, ids=IDS)
def test_pick_cdef_presets_on_the_exact_maps_returns_the_jax_picks(
        bd, w, h, noise):
    m = _maps(np.random.default_rng(bd * 1000 + w + 1), w, h, bd, noise)
    el = cdef.eligible_fbs(m["ns"], m["fw"], m["fh"])
    for is_key in (True, False):
        lam = jrdoq.compute_rdmult(120, bd, is_key, 0, 2)
        got = cdef.pick_cdef_presets(*m["port"], el, lam)
        want = jcdef.pick_cdef_presets(*m["jax"], el, lam)
        assert got[:3] == want[:3]
        np.testing.assert_array_equal(got[3], want[3])
        margins = pick_margins(*m["port"], el, lam)
        print(f"bd {bd} {w}x{h} lambda {lam}: cdef_bits {got[0]}, margins "
              f"(bits, lists, index) {margins}")
        assert min(margins) > 0


@pytest.mark.parametrize("bd, w, h", [(8, 200, 136), (8, 64, 64),
                                      (10, 136, 72), (10, 72, 40)],
                         ids=["bd8_200x136", "bd8_64x64", "bd10_136x72",
                              "bd10_72x40"])
def test_frame_multi_plain_equals_the_jax_cdef_frame_multi(bd, w, h):
    rng = np.random.default_rng(bd + w)
    src, rec, skips, mi_r, mi_c = _frame(rng, w, h, bd, 12)
    fw, fh = mi_c * 4, mi_r * 4
    ns = torch.from_numpy(jcdef.nonskip_grid(skips, mi_r, mi_c))
    planes = [torch.from_numpy(r) for r in rec]
    dirs, var = cdef.cdef_direction(planes[0], fw, fh, bd - 8)
    nvfb, nhfb = (fh + 63) // 64, (fw + 63) // 64
    for nb in (1, 2, 4, 8):
        y_list = tuple(int(v) for v in rng.integers(0, 64, nb))
        uv_list = tuple(int(v) for v in rng.integers(0, 64, nb))
        idx = rng.integers(0, nb, (nvfb, nhfb)).astype(np.int32)
        for damping in (3, 6):
            want = jcdef.cdef_frame_multi(rec, skips, mi_r, mi_c, y_list,
                                          uv_list, idx, damping, bd)
            got = cdef.cdef_frame_multi_plain(planes, ns, dirs, var, y_list,
                                              uv_list, idx, damping, fw, fh,
                                              bd)
            # the CPU wrapper takes the plain version
            via = cdef.cdef_apply_multi(planes, ns, dirs, var, y_list,
                                        uv_list, idx, damping, fw, fh, bd)
            for p in range(3):
                np.testing.assert_array_equal(got[p].numpy(), want[p])
                assert torch.equal(via[p], got[p])
    assert cdef.cdef_apply_multi.launches == 0


def test_frame_multi_with_one_preset_is_the_frame_level_apply():
    rng = np.random.default_rng(5)
    src, rec, skips, mi_r, mi_c = _frame(rng, 200, 136, 8, 12)
    fw, fh = mi_c * 4, mi_r * 4
    ns = torch.from_numpy(jcdef.nonskip_grid(skips, mi_r, mi_c))
    planes = [torch.from_numpy(r) for r in rec]
    dirs, var = cdef.cdef_direction(planes[0], fw, fh, 0)
    idx = np.zeros(((fh + 63) // 64, (fw + 63) // 64), np.int32)
    for y_str, uv_str in ((37, 14), (0, 6), (61, 0)):
        got = cdef.cdef_frame_multi_plain(planes, ns, dirs, var, (y_str,),
                                          (uv_str,), idx, 4, fw, fh, 8)
        want = cdef.cdef_apply_plain(planes, ns, dirs, var, y_str, uv_str,
                                     4, fw, fh, 8)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_search_fb_sums_to_the_frame_level_search():
    m = _maps(np.random.default_rng(9), 200, 136, 8, 10)
    dt = torch.uint8
    err_y, err_uv = cdef.search_plain(
        [torch.from_numpy(s).to(dt) for s in m["src"]],
        [torch.from_numpy(r) for r in m["rec"]], torch.from_numpy(m["dirs"]),
        torch.from_numpy(m["var"]), torch.from_numpy(m["ns"]), m["fw"],
        m["fh"], m["damping"], 8)
    for fb, frame in zip(m["port"], (err_y, err_uv)):
        np.testing.assert_array_equal(fb.sum((1, 2)).reshape(8, 4),
                                      frame.numpy())


def test_preset_lists_hold_one_to_eight_strengths():
    """The per-fb apply reads each list as 8 strengths of 6 bits."""
    assert cdef._strength_pack((63, 0, 5)) == 63 | 5 << 12
    for bad in ((), tuple(range(9))):
        with pytest.raises(ValueError):
            cdef._strength_pack(bad)


def test_eligible_fbs_are_the_blocks_with_a_non_skip_unit():
    ns = np.zeros((17, 25), bool)
    ns[3, 4] = ns[16, 24] = ns[9, 17] = True
    el = cdef.eligible_fbs(ns, 200, 136)
    assert el.shape == (3, 4)
    assert set(zip(*np.nonzero(el))) == {(0, 0), (2, 3), (1, 2)}


def _rotzoom_pair(h, w, a, b, tx, ty, seed=3):
    """A textured source and its reference under x' = a x + b y + tx,
    y' = -b x + a y + ty (the source sampled at the mapped positions)."""
    rng = np.random.default_rng(seed)
    big = rng.normal(128, 40, (h + 64, w + 64))
    k = np.ones(5) / 5
    big = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, big)
    big = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, big)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    ref = np.clip(big[32:32 + h, 32:32 + w] * 1.6 - 80, 0, 255)
    xs = a * xx + b * yy + tx
    ys = -b * xx + a * yy + ty
    xi = np.clip(np.rint(xs).astype(int) + 32, 0, w + 63)
    yi = np.clip(np.rint(ys).astype(int) + 32, 0, h + 63)
    src = np.clip(big[yi, xi] * 1.6 - 80, 0, 255)
    return src.astype(np.uint8), ref.astype(np.int32)


@pytest.mark.parametrize("a, b, tx, ty", [
    (1.0, 0.0, 3.0, -2.0), (1.01, 0.005, 1.5, 0.5), (0.99, -0.004, -2.0, 1.0)],
    ids=["translate", "zoom_in_rotate", "zoom_out_rotate"])
def test_estimate_rotzoom_copy_returns_the_jax_parameters(a, b, tx, ty):
    src, ref = _rotzoom_pair(128, 192, a, b, tx, ty)
    got = global_motion.estimate_rotzoom(src, ref)
    want = jgm.estimate_rotzoom(src, ref)
    assert got == want
    assert got is not None
    wmtype, mat = got
    assert wmtype == global_motion.warp_ops.ROTZOOM and mat[2] == mat[5]


@pytest.mark.slow
def test_jax_per_fb_search_and_pick_equal_the_ports_at_1080p():
    """A synthetic 1080p key frame: the JAX per-fb search (float32) and its
    picks against the port's exact maps and picks, with the margins."""
    rng = np.random.default_rng(1080)
    w, h = 1920, 1080
    m = None
    for bd, noise in ((8, 8), (10, 8)):
        m = _maps(rng, w, h, bd, noise)
        for got, f32 in zip(m["port"], m["jax"]):
            np.testing.assert_allclose(got, f32, rtol=2 ** -20, atol=0)
        el = cdef.eligible_fbs(m["ns"], m["fw"], m["fh"])
        lam = jrdoq.compute_rdmult(120, bd, True, 0, 2)
        got = cdef.pick_cdef_presets(*m["port"], el, lam)
        want = jcdef.pick_cdef_presets(*m["jax"], el, lam)
        margins = pick_margins(*m["port"], el, lam)
        print(f"1080p bd {bd}: cdef_bits {got[0]}, lists {got[1:3]}, "
              f"margins (bits, lists, index) {margins}; float32 sums "
              f"above 2^24: {int((m['port'][0] > 1 << 24).sum())}")
        assert got[:3] == want[:3]
        np.testing.assert_array_equal(got[3], want[3])


def _codec_pair(w, h, bd, seed):
    """The JAX package's FrameCodec and the port's on the same key-frame
    header, source, recon and skips (the recon: the source plus noise),
    as a coded frame hands them to the filter searches."""
    from svt_av1_tpu.bitstream.headers import FrameHeader as RefFH
    from svt_av1_tpu.bitstream.headers import SequenceHeader as RefSeq
    from svt_av1_tpu.pipeline.frame_codec import FrameCodec as RefCodec
    from svt_av1_tpu_torch.bitstream.headers import (FrameHeader,
                                                     SequenceHeader)
    from svt_av1_tpu_torch.pipeline.frame_codec import FrameCodec

    rng = np.random.default_rng(seed)
    src, rec, skips, mi_r, mi_c = _frame(rng, w, h, bd, 10)
    dt = np.uint8 if bd == 8 else np.uint16
    planes = tuple(s.astype(dt) for s in src)
    out = []
    for seq_c, fh_c, codec_c, kw in (
            (RefSeq, RefFH, RefCodec, {}),
            (SequenceHeader, FrameHeader, FrameCodec,
             dict(device=torch.device("cpu")))):
        seq = seq_c(max_frame_width=w, max_frame_height=h, bit_depth=bd)
        seq.enable_cdef = True
        fh = fh_c(frame_type=0, frame_width=w, frame_height=h,
                  base_q_idx=120, cdef_damping=4)
        codec = codec_c(seq, fh, source_planes=planes, **kw)
        for p in range(3):
            ph, pw = rec[p].shape
            codec.recon[p][:ph, :pw] = rec[p]
        codec.skips[:mi_r, :mi_c] = skips
        out.append(codec)
    return out


@pytest.mark.parametrize("bd", [8, 10])
def test_frame_codec_multi_search_and_apply_equal_the_jax_codecs(bd):
    """FrameCodec.search_and_apply_cdef_multi (K3, K4's per-fb forms, the
    host pick) sets the JAX codec's header fields, index grid and recon
    on the same frame; search_cdef its frame-level strengths."""
    ref, port = _codec_pair(200, 136, bd, 3 + bd)
    lam = jrdoq.compute_rdmult(120, bd, True, 0, 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SVT_TPU_DEVICE", "0")
        want = ref.search_and_apply_cdef_multi(lam)
    got = port.search_and_apply_cdef_multi(lam)
    assert got == want and port.fh.cdef_bits > 0
    for k in ("cdef_bits", "cdef_y_strengths", "cdef_uv_strengths"):
        assert getattr(port.fh, k) == getattr(ref.fh, k), k
    np.testing.assert_array_equal(port.cdef_idx_grid, ref.cdef_idx_grid)
    for p in range(3):
        np.testing.assert_array_equal(port.recon[p], ref.recon[p])
    ref, port = _codec_pair(200, 136, bd, 3 + bd)
    port.search_cdef()
    src = [s.astype(np.int32) for s in ref.source]
    fw, fh = ref.mi_cols * 4, ref.mi_rows * 4
    ns = jcdef.nonskip_grid(ref.skips, ref.mi_rows, ref.mi_cols)
    dirs, var = jcdef.find_dir_grid(jcdef._units_of(
        jcdef.pad_very_large(ref.recon[0], fw, fh, 8, np), fw, fh, 8, np),
        bd - 8, np)
    errs = jcdef.cdef_search_errs(src, ref.recon, dirs, var, ns, fw, fh,
                                  ref.fh.cdef_damping, bd, xp=np)
    want = [cdef.PRI_SET[int(np.argmin(e)) // 4] * 4
            + cdef.SEC_SET[int(np.argmin(e)) % 4] for e in errs]
    assert (port.fh.cdef_y_strengths, port.fh.cdef_uv_strengths) == (
        (want[0],), (want[1],))
