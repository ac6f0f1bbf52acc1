"""10-bit 4:2:0 all-intra in the port (svt_av1_tpu_torch) on the CPU,
against the JAX package.

The 16-bit forms of K1 (intra_decision.cu) and of K4's search
(cdef_filter.cu) run only on the card; here their plain versions, which
the wrappers take for CPU tensors, are held against the JAX package's
numpy twins at bd 10, and the whole slice against the JAX device path
(its jitted programs on the CPU backend, SVT_TPU_DEVICE=1):

* K1's plain version against ``intra_decision_arrays(..., 10, np)`` at
  the gates of tests/test_torch_omd.py (modes equal on >= 97% of the
  blocks per shape, costs within rtol 1e-5 on >= 99%);
* the quantizer model's constants at bd 10 (``_quant_maps``), equal;
* C1's near-boundary margin (ops/omd.py ``near_margin``) at 10-bit
  residual magnitudes, with the room it has at 8 bits;
* K4's search (``search_plain``) against ``cdef_search_errs(...,
  bit_depth=10, xp=np)`` on one and three planes, and against the
  twin's filtered planes summed exactly;
* 10-bit all-intra streams at 64x64x2 and 128x96x3 coded by the port,
  byte-identical to the JAX device path's; the JAX decoder and the
  port's Decoder reproduce the port's recon.

The 10-bit inputs are made from a seed with numpy as tests/test_e2e.py
``tenbit_clip`` makes them.
"""
import functools

import numpy as np
import pytest
import torch

import jax_refs
from svt_av1_tpu import api as ref_api
from svt_av1_tpu.config import EncoderConfig as RefConfig
from svt_av1_tpu.config import PredStructure as RefPred
from svt_av1_tpu.ops import cdef as ref_cdef
from svt_av1_tpu.ops import omd as ref_omd
from svt_av1_tpu.ops import quant as ref_qz
from svt_av1_tpu_torch import api
from svt_av1_tpu_torch.config import EncoderConfig, PredStructure
from svt_av1_tpu_torch.entropy.tables import FrameCdfs
from svt_av1_tpu_torch.io import IvfReader
from svt_av1_tpu_torch.ops import cdef, omd
from svt_av1_tpu_torch.pipeline.batched_md import default_mode_bits
from svt_av1_tpu_torch.pipeline.rdo import rd_lambda

from test_e2e import tenbit_clip

BD = 10
ALLINTRA = dict(qp=40, enc_mode=8, intra_period_length=0,
                encoder_bit_depth=BD)


def _textured10(h, w, seed):
    """A 10-bit luma plane: waves spanning most of [0, 1024) and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return (480 + 320 * np.sin(xx / 11) + 160 * np.cos(yy / 7)
            + rng.integers(-48, 49, (h, w))).clip(0, 1023).astype(np.uint16)


# --------------------------------------------------------------------------
# K1's plain version at bd 10
# --------------------------------------------------------------------------

@pytest.mark.parametrize("qindex", [60, 160])
def test_quant_model_constants_equal_at_10_bits(qindex):
    pq = ref_qz.build_quantizer(BD)[0]
    assert np.array_equal(pq.dequant, omd.qz.build_quantizer(BD)[0].dequant)
    for (w, h) in omd.ALL_SHAPES:
        for a, b in zip(omd._quant_maps(w, h, qindex, pq),
                        ref_omd._quant_maps(w, h, qindex, pq, np)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("qindex", [60, 160])
def test_intra_decision_at_10_bits_matches_numpy_twin(qindex):
    plane = _textured10(96, 128, 5)
    lam = rd_lambda(qindex, BD)
    mb = default_mode_bits(FrameCdfs(qindex))
    want = ref_omd.intra_decision_arrays(ref_omd.pad_plane(plane), 128, 96,
                                         qindex, lam, mb, BD, np)
    t = torch.from_numpy(plane.astype(np.int16))
    got = omd.intra_decision_arrays(omd.pad_plane(t), 128, 96, qindex, lam,
                                    mb, BD)
    for s in omd.ALL_SHAPES:
        mw, cw = want[s]
        mg, cg = (x.numpy() for x in got[s])
        assert mg.dtype == np.int32 and cg.dtype == np.float32
        assert (mg == mw).mean() >= 0.97, (s, (mg == mw).mean())
        close = np.isclose(cg, cw, rtol=1e-5).mean()
        assert close >= 0.99, (s, close)
    # the K1 wrapper on the int16 CPU plane takes the same plain version
    packed = omd.intra_decision_packed(t, qindex, lam, mb, BD)
    assert torch.equal(packed, omd.pack_decisions(got, omd.ALL_SHAPES))


@pytest.mark.parametrize("shape", omd.INTER_SHAPES)
def test_near_margin_bounds_the_float32_error_at_10_bits(shape):
    """C1's delta = near_margin(w, h) * sum |R| lies above the float32
    products' error |cf32 - cf64| on 10-bit residual blocks (uniform
    noise of 1023, flat offsets of 800, sparse spikes) with the room it
    has at 8 bits (delta / 8): both scale with the residual's
    magnitude."""
    w, h = shape
    rng = np.random.default_rng(w * 100 + h + BD)
    blocks = np.concatenate([
        rng.integers(-1023, 1024, (16, h, w)),
        np.full((4, h, w), 800) * rng.choice([-1, 1], (4, 1, 1)),
        np.where(rng.random((8, h, w)) < 0.02,
                 rng.integers(-1023, 1024, (8, h, w)), 0)]).astype(np.int32)
    r = torch.from_numpy(blocks)
    dh = torch.from_numpy(omd._dct_mat(h))
    dwt = torch.from_numpy(np.ascontiguousarray(omd._dct_mat(w).T))
    cf32 = dh @ r.to(torch.float32) @ dwt
    cf64 = dh.double() @ r.double() @ dwt.double()
    err = (cf32.double() - cf64).abs().amax(dim=(-1, -2))
    delta = r.abs().sum(dim=(-1, -2)).to(torch.float32) \
        * float(omd.near_margin(w, h))
    assert bool(((err < delta.double() / 8) | (err == 0)).all()), \
        (err / delta.double()).max().item()


# --------------------------------------------------------------------------
# K4's search at bd 10
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cdef_inputs():
    """A 10-bit 128x96 frame: source planes, a noisy int32 recon of them,
    the recon's CDEF directions (coeff_shift 2) and a random nonskip
    map."""
    fw, fh = 128, 96
    y, u, v = tenbit_clip(fw, fh, 1, seed=21)[0]
    rng = np.random.default_rng(23)
    src = [p.astype(np.int32) for p in (y, u, v)]
    rec = [(p + rng.integers(-40, 41, p.shape)).clip(0, 1023)
           .astype(np.int32) for p in src]
    padded = ref_cdef.pad_very_large(rec[0], fw, fh, 8, np)
    dirs, var = ref_cdef.find_dir_grid(
        ref_cdef._units_of(padded, fw, fh, 8, np), BD - 8, np)
    ns = rng.random(dirs.shape) < 0.7
    return fw, fh, src, rec, dirs, var, ns


def _exact_twin_errs(src, rec, dirs, var, ns, fw, fh, damping, pri_set,
                     sec_set):
    """cdef_search_errs of the numpy twin with its float32 sums replaced by
    exact int64 ones: the twin's own filtered planes (_PlaneCtx.run),
    summed over the in-frame nonskip samples."""
    cs = BD - 8
    out = []
    for group in ((0,), (1, 2)):
        acc = np.zeros((len(pri_set), len(sec_set)), np.int64)
        for pli in group:
            if pli >= len(rec):
                continue
            bs, sub = (8, 0) if pli == 0 else (4, 1)
            pw, ph = fw >> sub, fh >> sub
            padded = ref_cdef.pad_very_large(rec[pli], pw, ph, bs, np)
            keep = np.repeat(np.repeat(ns, bs, 0), bs, 1)[:ph, :pw]
            ctx = {True: ref_cdef._PlaneCtx(padded, dirs, bs, np),
                   False: ref_cdef._PlaneCtx(padded, np.zeros_like(dirs),
                                             bs, np)}
            dmp = damping + cs - (0 if pli == 0 else 1)
            H, Wd = padded.shape[0] - 4, padded.shape[1] - 4
            for i, pri in enumerate(pri_set):
                p = pri << cs
                if pli == 0:
                    pmap = np.repeat(np.repeat(ref_cdef._adjust_strength_xp(
                        p, var, np), bs, 0), bs, 1)
                else:
                    pmap = np.full((H, Wd), p, np.int32)
                for j, sec in enumerate(sec_set):
                    s_ = (sec + (sec == 3)) << cs
                    filt = ctx[bool(p)].x if p == 0 and s_ == 0 \
                        else ctx[bool(p)].run(pmap, s_, dmp, cs)
                    d = (np.asarray(filt)[:ph, :pw].astype(np.int64)
                         - src[pli][:ph, :pw])
                    acc[i, j] += int((d * d)[keep].sum())
        out.append(acc)
    return out


@pytest.mark.parametrize("n_planes", [1, 3])
@pytest.mark.parametrize("sets", ["fast", "full"])
def test_cdef_search_at_10_bits_matches_numpy_twin(cdef_inputs, n_planes,
                                                   sets):
    """search_plain at bit_depth 10 on int16 sources: exactly the twin's
    filtered planes summed in int64, and the twin's float32 sums to rtol
    1e-5 (float32 addition of about 10^4 terms up to 1023^2) with the
    same argmin."""
    fw, fh, src, rec, dirs, var, ns = cdef_inputs
    pri_set, sec_set = (cdef.PRI_SET_FAST, cdef.SEC_SET_FAST) \
        if sets == "fast" else (cdef.PRI_SET, cdef.SEC_SET)
    damping = 5
    src, rec = src[:n_planes], rec[:n_planes]
    got = cdef.cdef_search(
        [torch.from_numpy(p.astype(np.int16)) for p in src],
        [torch.from_numpy(p) for p in rec], torch.from_numpy(dirs),
        torch.from_numpy(var), torch.from_numpy(ns), fw, fh, damping, BD,
        pri_set, sec_set)
    exact = _exact_twin_errs(src, rec, dirs, var, ns, fw, fh, damping,
                             pri_set, sec_set)
    twin = ref_cdef.cdef_search_errs(src, rec, dirs, var, ns, fw, fh,
                                     damping, BD, pri_set, sec_set, np)
    assert (got[1] is None) == (n_planes == 1)
    for g, e, t in zip(got, exact, twin):
        if g is None:
            continue
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), e)
        np.testing.assert_allclose(g.numpy(), t, rtol=1e-5)
        assert int(torch.argmin(g.reshape(-1))) == int(np.argmin(t))


# --------------------------------------------------------------------------
# the slice end to end
# --------------------------------------------------------------------------

SIZES = {"64x64x2": (64, 64, 2), "128x96x3": (128, 96, 3)}


def _ref_cfg(w, h):
    return RefConfig(source_width=w, source_height=h,
                     pred_structure=RefPred.LOW_DELAY_P, **ALLINTRA)


def _jax_case(size):
    w, h, n = SIZES[size]
    return jax_refs.encode_case(tenbit_clip(w, h, n), _ref_cfg(w, h))


for _size in SIZES:
    jax_refs.register(f"tenbit.{_size}", functools.partial(_jax_case, _size))


@pytest.fixture(scope="module", params=list(SIZES))
def streams(request, tmp_path_factory):
    """(port bytes, port recon, port IVF path, JAX device-path bytes) of a
    10-bit all-intra clip."""
    w, h, n = SIZES[request.param]
    frames = tenbit_clip(w, h, n)
    tmp = tmp_path_factory.mktemp(f"tenbit_{request.param}")
    cfg = EncoderConfig(source_width=w, source_height=h,
                        pred_structure=PredStructure.LOW_DELAY_P, **ALLINTRA)
    port = tmp / "port.ivf"
    recon = api.encode_ivf(frames, cfg, str(port), device="cpu")
    return (port.read_bytes(), recon, port,
            jax_refs.reference(f"tenbit.{request.param}", frames=frames,
                               cfg=_ref_cfg(w, h)))


# 152 s with the JAX side live (a stale store) in the 6-worker run
@pytest.mark.time_limit(310)
def test_stream_byte_identical_to_jax_device_path(streams):
    data, recon, _, want = streams
    assert recon[0][0].dtype == np.uint16
    assert len(data) == len(want)
    assert data == want


def test_decoders_reproduce_the_recon(streams):
    """The JAX decoder and the port's Decoder (host walk, plain K2-K4)
    both give the port encoder's recon, and the stream's sequence header
    says 10 bits."""
    _, recon, path, _ = streams
    for frames in (ref_api.decode_ivf(str(path))[0],
                   api.decode_ivf(str(path), device="cpu")[0]):
        assert len(frames) == len(recon)
        for got, want in zip(frames, recon):
            for p in range(3):
                assert got[p].dtype == np.uint16
                np.testing.assert_array_equal(got[p], want[p])
    dec = api.Decoder(device="cpu")
    dec.decode_frame(next(iter(IvfReader(str(path))))[0])
    assert dec.get_stream_info()["bit_depth"] == BD
