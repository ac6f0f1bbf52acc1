"""State carried across from the JAX package to the port: the constant
tables (byte-for-byte equal arrays) and the encoder configuration (the
same derived coding signals)."""
import dataclasses
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

import svt_av1_tpu
from svt_av1_tpu import config as ref_config
from svt_av1_tpu.ops import bme as ref_bme
from svt_av1_tpu.ops import inter as ref_inter
from svt_av1_tpu.ops import quant as ref_qz
from svt_av1_tpu.pipeline import batched_inter as ref_bi
from svt_av1_tpu.pipeline import mctf as ref_mctf
from svt_av1_tpu.pipeline import tpl as ref_tpl
from svt_av1_tpu_torch import config, convert

REF_DIR = Path(svt_av1_tpu.__file__).resolve().parent
REF_TABLES = {"av1_tables": "entropy/data/av1_tables.npz",
              "txfm_stages": "ops/data/txfm_stages.npz",
              "rc_tables": "pipeline/data/rc_tables.npz"}


def _ref_arrays():
    out = {}
    for name, rel in REF_TABLES.items():
        with np.load(REF_DIR / rel) as z:
            out[name] = {k: z[k] for k in z.files}
    return out


@pytest.mark.parametrize("name", sorted(REF_TABLES))
def test_table_files_hold_equal_arrays(name):
    with np.load(REF_DIR / REF_TABLES[name]) as a, \
            np.load(convert.TABLE_FILES[name]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tables_from_reference_loads_and_refuses_a_mismatch():
    ref = _ref_arrays()
    got = convert.tables_from_reference(ref)
    assert set(got) == set(REF_TABLES)
    name = sorted(ref["rc_tables"])[0]
    bad = {k: dict(v) for k, v in ref.items()}
    bad["rc_tables"][name] = bad["rc_tables"][name].copy()
    bad["rc_tables"][name].flat[0] += 1
    with pytest.raises(ValueError):
        convert.tables_from_reference(bad)
    del bad["rc_tables"]
    with pytest.raises(ValueError):
        convert.tables_from_reference(bad)


@pytest.mark.parametrize("kw", [
    dict(source_width=1920, source_height=1080, qp=40, enc_mode=8,
         intra_period_length=0,
         pred_structure=ref_config.PredStructure.LOW_DELAY_P),
    dict(source_width=176, source_height=144, qp=30, enc_mode=4,
         frame_rate=Fraction(30000, 1001), tile_columns=1,
         rate_control_mode=ref_config.RateControlMode.VBR),
], ids=["slice_1080p", "other"])
def test_config_carried_across_derives_the_same_signals(kw):
    ref_cfg = ref_config.EncoderConfig(**kw)
    cfg = convert.config_from_reference(dataclasses.asdict(ref_cfg))
    assert isinstance(cfg, config.EncoderConfig)
    assert dataclasses.asdict(config.derive_signals(cfg)) == \
        dataclasses.asdict(ref_config.derive_signals(ref_cfg))
    # plain ints and (num, den) pairs, as a file would hold them
    plain = {k: (int(v) if isinstance(v, int) else v)
             for k, v in dataclasses.asdict(ref_cfg).items()}
    plain["frame_rate"] = (ref_cfg.frame_rate.numerator,
                           ref_cfg.frame_rate.denominator)
    assert convert.config_from_reference(plain) == cfg


def test_config_from_reference_refuses_unknown_fields():
    d = dataclasses.asdict(ref_config.EncoderConfig(source_width=64,
                                                    source_height=64))
    d["no_such_field"] = 1
    with pytest.raises(ValueError):
        convert.config_from_reference(d)


def _ref_constants():
    return {
        "bme": {n: getattr(ref_bme, n) for n in (
            "SB", "COARSE_R", "REFINE_R", "MARGIN", "ME_SHAPES",
            "SUBPEL_DELTAS")},
        "selection": {n: getattr(ref_bi, n) for n in (
            "REF_PEN_SB", "COMP_PEN_SB", "DEV_PEN", "SEL_MV_W",
            "PEN_TUNE_QINDEX", "MV_BIT_SCALE", "INTER_MODE_BITS")},
        "interp": {"REGULAR": np.stack(
            [ref_inter.interp_kernel(ref_inter.REGULAR, q4, 16)
             for q4 in range(16)]).tolist()},
        "compound": {n: getattr(ref_bi, n) for n in ("MC_PAD", "JOINT_R")},
        "mctf": {n: getattr(ref_mctf, n) for n in (
            "BLK", "WINDOW_BALANCE", "WEIGHT_SCALE", "DIST_THRESHOLD",
            "EDGE_THRESHOLD", "SQRT_PI_BY_2")},
        "tpl": {n: getattr(ref_tpl, n) for n in ("QSTEP_PER_OCTAVE",
                                                 "MAX_BOOST")},
        "quantizer": convert.quantizer_constants(ref_qz.build_quantizer),
    }


@pytest.mark.parametrize("group", ["compound", "mctf", "tpl"])
def test_random_access_constants_equal_the_reference(group):
    """The compound joint search (K9), the temporal filter and the TPL
    model's constants, each against the JAX module's value."""
    ref = _ref_constants()
    got = convert.constants_from_reference(ref)[group]
    assert set(got) == set(ref[group])
    for k, v in ref[group].items():
        assert got[k] == v, (group, k)
    bad = {g: dict(v) for g, v in ref.items()}
    name = sorted(bad[group])[0]
    bad[group][name] = bad[group][name] * 2 + 1
    with pytest.raises(ValueError):
        convert.constants_from_reference(bad)


@pytest.mark.parametrize("bad", [None, "value", "missing", "shape"])
def test_constants_from_reference_loads_and_refuses_a_mismatch(bad):
    ref = _ref_constants()
    if bad is None:
        got = convert.constants_from_reference(ref)
        assert got["bme"]["REFINE_R"] == 16
        assert got["interp"]["REGULAR"].shape == (16, 8)
        return
    if bad == "value":
        ref["selection"]["DEV_PEN"] += 1.0
    elif bad == "missing":
        del ref["bme"]["MARGIN"]
    else:
        ref["bme"]["ME_SHAPES"] = ref["bme"]["ME_SHAPES"][:-1]
    with pytest.raises(ValueError):
        convert.constants_from_reference(ref)


@pytest.mark.parametrize("bd", convert.QUANT_BIT_DEPTHS)
def test_quantizer_tables_equal_the_reference(bd):
    """The quantizer tables K1's cost model reads (every field of the luma
    PlaneQuant, 256 qindex x (DC, AC)), array by array against the JAX
    package's, at 8 and 10 bits; a changed entry is refused."""
    ref = _ref_constants()
    got = convert.constants_from_reference(ref)["quantizer"]
    names = [k for k in ref["quantizer"] if k.endswith(f"_{bd}bit")]
    assert len(names) == 7
    for k in names:
        assert got[k].dtype == np.int16 and got[k].shape == (256, 2), k
        np.testing.assert_array_equal(got[k], ref["quantizer"][k], err_msg=k)
    bad = {g: dict(v) for g, v in ref.items()}
    bad["quantizer"][f"dequant_{bd}bit"] = \
        bad["quantizer"][f"dequant_{bd}bit"].copy()
    bad["quantizer"][f"dequant_{bd}bit"][160, 1] += 1
    with pytest.raises(ValueError):
        convert.constants_from_reference(bad)
