"""The stripe step of the port (svt_av1_tpu_torch/parallel/, the plain
versions of K1 and K4-K8 in their stripe modes) against the JAX
package's numpy twins (xp=np) and against the port's own whole-frame
run: MVs, predictions, deblocking level, CDEF strength and planes
exactly equal; float costs within rtol 2e-4 / atol 2 on >= 99% of the
blocks and intra modes on >= 97% (the gates of tests/test_omd.py and
the JAX dryrun); the DistStripes exchange over gloo equal to
LocalStripes."""
import functools
import time

import numpy as np
import pytest
import torch

from svt_av1_tpu.ops import bme as ref_bme
from svt_av1_tpu.ops import cdef as ref_cdef
from svt_av1_tpu.ops import dlf as ref_dlf
from svt_av1_tpu.ops import omd as ref_omd
from svt_av1_tpu.pipeline import batched_inter as ref_bi
from svt_av1_tpu_torch.ops import bme, cdef, omd
from svt_av1_tpu_torch.parallel import dryrun as dr
from svt_av1_tpu_torch.parallel import stripes as st
from svt_av1_tpu_torch.pipeline import batched_inter as bi

H, W = 128, 256


def _pair(seed):
    """(src, ref) uint8 [H, W]: the reference moved by (3.5, -5) pixels
    plus noise, so every stage has motion to find."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    ref = (120 + 60 * np.sin(xx / 9) + 40 * np.cos(yy / 7)
           + rng.integers(-10, 11, (H, W))).clip(0, 255).astype(np.uint8)
    a = np.roll(ref, (3, -5), axis=(0, 1)).astype(np.int32)
    b = np.roll(ref, (4, -5), axis=(0, 1)).astype(np.int32)
    src = ((a + b + 1) // 2 + rng.integers(-2, 3, (H, W))).clip(0, 255)
    return src.astype(np.uint8), ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("row0", [0, 64])
def test_frame_me_of_a_stripe_equals_the_twin_and_the_whole_frame(row0):
    src, ref = _pair(row0 + 1)
    stripe = src[row0:row0 + 64]
    want = ref_bme.frame_me(stripe.astype(np.int32), ref.astype(np.int32),
                            np, row0=row0)
    got = bme.frame_me(_t(stripe), _t(ref), row0=row0)
    whole = bme.frame_me(_t(src), _t(ref))
    n_sbx = W // 64
    rows = slice(row0 // 64 * n_sbx, (row0 // 64 + 1) * n_sbx)
    for s in bme.ME_SHAPES:
        for g, w, a in zip(got[s], want[s], whole[s]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), str(s))
            np.testing.assert_array_equal(g.numpy(), a[rows].numpy(), str(s))
    np.testing.assert_array_equal(got["win16"].numpy(), want["win16"])


@pytest.mark.parametrize("row0", [0, 64])
def test_subpel_of_a_stripe_equals_the_twin_and_the_whole_frame(row0):
    src, ref = _pair(7)
    rng = np.random.default_rng(row0)
    # MVs reaching past every edge of the frame
    mv_r, mv_c = rng.integers(-40, 41, (2, H // 16, W // 16)).astype(np.int32)
    u = slice(row0 // 16, (row0 + 64) // 16)
    want = ref_bme.subpel_refine16(src[row0:row0 + 64].astype(np.int32),
                                   ref.astype(np.int32), mv_r[u], mv_c[u],
                                   W, H, 8, np, row0)
    got = bme.subpel_refine16(_t(src[row0:row0 + 64]), _t(ref), _t(mv_r[u]),
                              _t(mv_c[u]), 8, row0)
    whole = bme.subpel_refine16(_t(src), _t(ref), _t(mv_r), _t(mv_c))
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), w)
        part = whole[k][u] if k < 2 else whole[k][row0:row0 + 64]
        np.testing.assert_array_equal(g.numpy(), part.numpy())


def test_inter_frame_maps_of_a_stripe_equal_the_twin():
    from svt_av1_tpu_torch.entropy.tables import FrameCdfs
    from svt_av1_tpu_torch.pipeline.batched_md import default_mode_bits
    from svt_av1_tpu_torch.pipeline.rdo import rd_lambda

    src, ref = _pair(3)
    q = 120
    lam, mb = rd_lambda(q, 8), default_mode_bits(FrameCdfs(q))
    stripe = src[64:]
    _, cost1, sf1, mvb1 = ref_bi.inter_frame_maps(
        stripe.astype(np.int32), ref.astype(np.int32), W, H, q, lam, mb, 8,
        np, row0=64, with_intra=False, pens=bi.selection_pens(q))
    intra, cost, sf, mvb = bi.inter_frame_maps(_t(stripe), [_t(ref)], q,
                                               lam, mb, row0=64,
                                               with_intra=False)
    assert intra is None
    for k in ("sel", "mv_r", "mv_c"):
        np.testing.assert_array_equal(sf[k].numpy(), sf1[k], k)
    np.testing.assert_allclose(mvb.numpy(), mvb1, rtol=1e-6)
    for s, c in cost.items():
        close = np.isclose(c.numpy(), cost1[s], rtol=2e-4, atol=2.0).mean()
        assert close >= 0.99, (s, close)


def test_compound_and_intra_maps_on_a_stripe_raise():
    src, ref = _pair(3)
    with pytest.raises(NotImplementedError):
        bi.inter_frame_maps(_t(src[64:]), [_t(ref), _t(ref)], 120, 10.0,
                            (1.0,) * 13, bwd_mask=(False, True),
                            allow_compound=True, row0=64, with_intra=False)
    with pytest.raises(ValueError, match="halo"):
        bi.inter_frame_maps(_t(src[64:]), [_t(ref)], 120, 10.0, (1.0,) * 13,
                            row0=64)


def _jax_padded_stripe(stripe, above_row, below_rows):
    """The padded stripe of __graft_entry__.py:235-243."""
    rows, w = stripe.shape
    padded = ref_omd.pad_plane(stripe.astype(np.int32))
    padded[ref_omd.PAD - 1, ref_omd.PAD:ref_omd.PAD + w] = above_row
    padded[ref_omd.PAD - 1, :ref_omd.PAD] = above_row[0]
    padded[ref_omd.PAD - 1, ref_omd.PAD + w:] = above_row[-1]
    r0 = ref_omd.PAD + rows
    padded[r0:r0 + len(below_rows), ref_omd.PAD:ref_omd.PAD + w] = below_rows
    padded[r0:r0 + len(below_rows), ref_omd.PAD - 1] = below_rows[:, 0]
    return padded


@pytest.mark.parametrize("index", [0, 1, 2], ids=["first", "middle", "last"])
def test_intra_halo_mode_equals_the_twin(index):
    """K1's stripe mode (its plain version) against the JAX decision on
    the stripe padded as the JAX dryrun pads it; records the share of
    equal modes."""
    rng = np.random.default_rng(index)
    yy, xx = np.mgrid[0:192, 0:W]
    plane = (120 + 80 * np.sin(xx / 11) + 40 * np.cos(yy / 7)
             + rng.integers(-12, 13, (192, W))).clip(0, 255).astype(np.uint8)
    r0 = index * 64
    stripe = plane[r0:r0 + 64]
    above = stripe[0] if index == 0 else plane[r0 - 1]
    below = np.broadcast_to(stripe[-1:], (st.HALO, W)) if index == 2 \
        else plane[r0 + 64:r0 + 64 + st.HALO]
    padded = _jax_padded_stripe(stripe, above.astype(np.int32),
                                below.astype(np.int32))
    got_pad = omd.pad_stripe(_t(stripe), _t(above), _t(below))
    np.testing.assert_array_equal(got_pad.numpy(), padded)
    q, lam, mb = 140, 300.0, tuple(np.linspace(1.0, 6.0, 13).tolist())
    want = ref_omd.intra_decision_arrays(padded, W, 64, q, lam, mb, 8, np)
    shares = {}
    for (w, h) in omd.ALL_SHAPES:
        m, c = omd.intra_decision(_t(stripe), w, h, q, lam, mb, 8,
                                  _t(above), _t(below))
        m1, c1 = want[(w, h)]
        shares[(w, h)] = float((m.numpy() == m1).mean())
        assert shares[(w, h)] >= 0.97, (w, h, shares[(w, h)])
        assert np.isclose(c.numpy(), c1, rtol=1e-5).mean() > 0.99, (w, h)
    print("intra modes equal per shape:", shares)


@pytest.mark.parametrize("top,bottom", [(False, False), (True, False),
                                        (False, True), (True, True)],
                         ids=["none", "top", "bottom", "both"])
def test_cdef_halo_search_and_apply_equal_the_twin(top, bottom):
    rng = np.random.default_rng(top + 2 * bottom)
    rows = 64
    yy, xx = np.mgrid[0:rows + 4, 0:W]
    smooth = 120 + 50 * np.sin(xx / 9) + 30 * np.cos(yy / 7)
    # a noisy recon of a smooth source: the search picks a strength
    full = (smooth + rng.integers(-8, 9, smooth.shape)).clip(0, 255) \
        .astype(np.int32)
    d = full[2:2 + rows]
    src = smooth[2:2 + rows].astype(np.uint8)
    ns = rng.random((rows // 8, W // 8)) < 0.8
    up = full[:2] if top else None
    dn = full[2 + rows:] if bottom else None
    pad = ref_cdef.pad_very_large(d, W, rows, 8, np)
    if top:
        pad[0:2, 2:2 + W] = up
    if bottom:
        pad[2 + rows:4 + rows, 2:2 + W] = dn
    halos = [(None if up is None else _t(up), None if dn is None else _t(dn))]
    np.testing.assert_array_equal(
        cdef.pad_halo(_t(d), W, rows, 8, *halos[0]).numpy(), pad)
    dirs, var = ref_cdef.find_dir_grid(
        ref_cdef._units_of(pad, W, rows, 8, np), 0, np)
    e1, _ = ref_cdef.cdef_search_errs([src.astype(np.int32)], [d], dirs, var,
                                      ns, W, rows, 3, 8, xp=np,
                                      padded_planes=[pad])
    dt, vt = cdef.cdef_direction(_t(d), W, rows)
    np.testing.assert_array_equal(dt.numpy(), dirs)
    e, e_uv = cdef.cdef_search([_t(src)], [_t(d)], dt, vt, _t(ns), W, rows,
                               3, halos=halos)
    assert e_uv is None
    np.testing.assert_allclose(e.numpy(), e1, rtol=1e-6)
    assert int(np.argmin(e.numpy())) == int(np.argmin(e1))
    ystr = cdef.pick_strength(e, cdef.PRI_SET, cdef.SEC_SET)
    want = ref_cdef._cdef_apply_traced([d], ns, ystr, 0, 3, W, rows, 8, np,
                                       padded_planes=[pad])[0]
    got = cdef.cdef_apply([_t(d)], _t(ns), dt, vt, ystr, 0, 3, W, rows, 8,
                          halos=halos)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    traced = cdef._cdef_apply_traced([_t(d)], _t(ns), ystr, 0, 3, W, rows, 8,
                                     padded_planes=[_t(pad)])[0]
    np.testing.assert_array_equal(traced.numpy(), want)
    assert ystr > 0 and not np.array_equal(want, d)


@pytest.fixture(scope="module")
def dryrun():
    return dr.dryrun_stripes(2, width=W, device="cpu")


def test_dryrun_stripes_matches_the_whole_frame_and_the_twin(dryrun):
    """The stripe step equals the port's whole-frame run (checked inside
    dryrun_stripes), and its deblocking level, CDEF strength and CDEF
    plane equal the JAX package's unsharded numpy reference, computed as
    __graft_entry__.py:319-350 computes it (float32 SSE sums)."""
    rep = dryrun
    assert rep["agreement"] == dict(intra_modes=1.0, intra_costs=1.0,
                                    inter_costs=1.0)
    assert rep["gop"]["frames"] == 8
    cap = rep["state"]
    n, rows = rep["n"], dr.ROWS
    fh, fw = cap["src"].shape
    src, recon = cap["src"], cap["recon"]
    av, fv, ah, fh_e = ref_dlf.edge_params(
        cap["tx_w"], cap["tx_h"], cap["skip_g"], cap["bex"], cap["bey"], fw,
        fh, False)
    cands = dr.dlf_candidates()

    def sse(p):
        return float(sum(np.float32(((p[i * rows:(i + 1) * rows]
                                      - src[i * rows:(i + 1) * rows]
                                      .astype(np.int32))
                                     .astype(np.float32) ** 2).sum())
                         for i in range(n)))

    filt = {lv: np.asarray(ref_dlf.loop_filter_plane_full(
        recon, av, fv, ah, fh_e, fw, fh, lv, lv, 0, 8, np)) for lv in cands}
    sses = [sse(recon)] + [sse(filt[lv]) for lv in cands]
    best = int(np.argmin(sses))
    level = 0 if best == 0 else cands[best - 1]
    dlf1 = recon if best == 0 else filt[level]
    pad1 = ref_cdef.pad_very_large(dlf1, fw, fh, 8, np)
    dirs, var = ref_cdef.find_dir_grid(
        ref_cdef._units_of(pad1, fw, fh, 8, np), 0, np)
    ns = ref_cdef.nonskip_grid(cap["skips"], fh // 4, fw // 4)
    err, _ = ref_cdef.cdef_search_errs([src.astype(np.int32)], [dlf1], dirs,
                                       var, ns, fw, fh, 3, 8, dr.PRI_SET,
                                       dr.SEC_SET, np)
    ei = int(np.argmin(np.asarray(err).ravel()))
    ystr = dr.PRI_SET[ei // 4] * 4 + dr.SEC_SET[ei % 4]
    cdef1 = ref_cdef.cdef_frame([dlf1], cap["skips"], fh // 4, fw // 4,
                                ystr, 0, 3, 8)[0]
    assert (rep["level"], rep["ystr"]) == (level, ystr)
    got = torch.cat([o["cdef"] for o in rep["outs"]]).numpy()
    np.testing.assert_array_equal(got, cdef1)


@functools.cache
def _local_run(n):
    """A captured 128 x 64n P frame, its stripes and LocalStripes' step
    outputs, on the CPU."""
    cap = dr.capture_inter_frame(n, 128, "cpu")
    frame = dr.frame_params(cap, "cpu")
    stripes = dr.build_stripes(cap, n, "cpu")
    return frame, stripes, st.stripe_step(frame, stripes, st.LocalStripes(n))


@pytest.mark.parametrize("what", ["level", "cdef", "mv_r", "intra_mode"])
def test_compare_holds_two_step_runs_to_the_gates(what):
    """``dryrun.compare`` passes a step run held against its own copy, with
    every agreement 1.0, and raises when one exact output or more than 1%
    of one shape's intra modes differ."""
    _, _, outs = _local_run(2)
    rep, err = dr.compare(outs, outs, [0, 1], modes=0.99,
                          intra_tol=(1e-5, 1e-8))
    assert rep == dict(intra_modes=1.0, intra_costs=1.0, inter_costs=1.0)
    assert err == 0.0
    bad = [dict(o) for o in outs]
    o = bad[1]
    if what == "level":
        o["level"] += 1
    elif what == "cdef":
        o["cdef"] = o["cdef"].clone()
        o["cdef"][5, 7] += 1
    elif what == "mv_r":
        o["fields"] = dict(o["fields"], mv_r=o["fields"]["mv_r"] + 8)
    else:
        m, c = o["intra"][(8, 8)]
        o["intra"] = dict(o["intra"])
        o["intra"][(8, 8)] = ((m + 1) % 13, c)
    with pytest.raises(AssertionError):
        dr.compare(bad, outs, [0, 1])


def _dist_worker(rank, n, store_path, inputs, out_path):
    import torch.distributed as dist

    torch.set_num_threads(1)          # the ranks share the test's cores
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n)
    try:
        frame, stripes = torch.load(inputs, weights_only=False)
        out = st.stripe_step(frame, [stripes[rank]], st.DistStripes())
        torch.save(out[0], f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n", [2, 4])
def test_dist_stripes_over_gloo_equal_local_stripes(n, tmp_path):
    frame, stripes, local_outs = _local_run(n)
    inputs = tmp_path / "inputs.pt"
    torch.save((frame, stripes), inputs)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dist_worker,
                         args=(r, n, str(tmp_path / "store"), str(inputs),
                               str(tmp_path / "out")))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 120
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 0))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks still running after 120 s: {hung}"
    assert [p.exitcode for p in procs] == [0] * n
    for r, local in enumerate(local_outs):
        got = torch.load(tmp_path / f"out.{r}", weights_only=False)
        assert (got["level"], got["ystr"]) == (local["level"], local["ystr"])
        for k in ("cdef", "dlf_sse", "cdef_err", "mvbits"):
            assert torch.equal(got[k], local[k]), (r, k)
        for k, v in local["fields"].items():
            assert torch.equal(got["fields"][k], v), (r, k)
        for s, (m, c) in local["intra"].items():
            assert torch.equal(got["intra"][s][0], m), (r, s)
            assert torch.equal(got["intra"][s][1], c), (r, s)
        for s, c in local["inter_cost"].items():
            assert torch.equal(got["inter_cost"][s], c), (r, s)
