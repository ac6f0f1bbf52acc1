"""Carry the reference encoder's state across to the port.

A codec has no weights: its state is the configuration and the constant
tables.  ``config_from_reference`` builds the port's EncoderConfig from a
plain dict of the JAX EncoderConfig's fields (``dataclasses.asdict`` of
it, or the same fields read from a file), and ``tables_from_reference``
takes the three table files' arrays and checks them, array by array,
against the copies this package loads, the way a strict state-dict load
refuses a mismatch.  ``constants_from_reference`` does the same for the
constants the inter kernels bake in (motion-search geometry, selection
penalties, the REGULAR interpolation taps, the compound joint search)
and for those of the temporal filter and the TPL model, and for the
quantizer tables that K1's cost model reads at 8 and 10 bits.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from pathlib import Path

import numpy as np

from .config import ColorFormat, EncoderConfig, PredStructure, \
    RateControlMode

PKG_DIR = Path(__file__).resolve().parent

# table set name -> the port's data file
TABLE_FILES = {
    "av1_tables": PKG_DIR / "entropy" / "data" / "av1_tables.npz",
    "txfm_stages": PKG_DIR / "ops" / "data" / "txfm_stages.npz",
    "rc_tables": PKG_DIR / "pipeline" / "data" / "rc_tables.npz",
}

_ENUMS = {"pred_structure": PredStructure,
          "rate_control_mode": RateControlMode,
          "encoder_color_format": ColorFormat}


def config_from_reference(d: dict) -> EncoderConfig:
    """The port's EncoderConfig with the reference config's fields.
    Enum fields may come as enums or ints, the frame rate as a Fraction
    or a (num, den) pair; unknown fields raise."""
    names = {f.name for f in dataclasses.fields(EncoderConfig)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"fields the port does not know: {sorted(extra)}")
    kw = {}
    for k, v in d.items():
        if k in _ENUMS:
            v = _ENUMS[k](int(v))
        elif k == "frame_rate" and not isinstance(v, Fraction):
            v = Fraction(*v) if isinstance(v, (tuple, list)) \
                else Fraction(v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    return EncoderConfig(**kw)


def load_tables() -> dict:
    """{table set: {name: array}} of the port's own data files."""
    out = {}
    for name, path in TABLE_FILES.items():
        with np.load(path) as z:
            out[name] = {k: z[k] for k in z.files}
    return out


def tables_from_reference(npz_arrays: dict) -> dict:
    """Load the reference's tables ({table set: {name: array}}, the
    three sets of TABLE_FILES) as numpy arrays, checking each against
    the port's copy; any missing, extra or differing array raises."""
    own = load_tables()
    if set(npz_arrays) != set(own):
        raise ValueError(f"table sets {sorted(npz_arrays)} != "
                         f"{sorted(own)}")
    out = {}
    for name, arrays in npz_arrays.items():
        mine = own[name]
        if set(arrays) != set(mine):
            diff = sorted(set(arrays) ^ set(mine))
            raise ValueError(f"{name}: arrays differ in names: {diff[:8]}")
        loaded = {}
        for k, v in arrays.items():
            a = np.asarray(v)
            if a.dtype != mine[k].dtype or a.shape != mine[k].shape \
                    or not np.array_equal(a, mine[k]):
                raise ValueError(f"{name}/{k} differs from the port's copy")
            loaded[k] = a
        out[name] = loaded
    return out


# the bit depths whose quantizer tables are checked (the luma tables of
# quant.build_quantizer, whose DC/AC scalars K1's cost model reads)
QUANT_BIT_DEPTHS = (8, 10)


def quantizer_constants(build_quantizer) -> dict:
    """{"<field>_<bd>bit": int16 [256, 2]} of the luma PlaneQuant that
    ``build_quantizer`` (this package's or the JAX package's
    ``ops.quant.build_quantizer``) makes at each of QUANT_BIT_DEPTHS."""
    out = {}
    for bd in QUANT_BIT_DEPTHS:
        pq = build_quantizer(bd)[0]
        for f in dataclasses.fields(pq):
            out[f"{f.name}_{bd}bit"] = getattr(pq, f.name)
    return out


def own_constants() -> dict:
    """{group: {name: value}} of the constants the inter kernels (K5-K9)
    bake in, of the MCTF and TPL models and of the quantizer tables, from
    this package's modules."""
    from .ops import bme, inter
    from .ops import quant as qz
    from .pipeline import batched_inter as bi
    from .pipeline import mctf, tpl

    return {
        "bme": {n: getattr(bme, n) for n in (
            "SB", "COARSE_R", "REFINE_R", "MARGIN", "ME_SHAPES",
            "SUBPEL_DELTAS")},
        "selection": {n: getattr(bi, n) for n in (
            "REF_PEN_SB", "COMP_PEN_SB", "DEV_PEN", "SEL_MV_W",
            "PEN_TUNE_QINDEX", "MV_BIT_SCALE", "INTER_MODE_BITS")},
        "interp": {"REGULAR": np.stack(
            [inter.interp_kernel(inter.REGULAR, q4, 16)
             for q4 in range(16)])},
        "compound": {n: getattr(bi, n) for n in ("MC_PAD", "JOINT_R")},
        "mctf": {n: getattr(mctf, n) for n in (
            "BLK", "WINDOW_BALANCE", "WEIGHT_SCALE", "DIST_THRESHOLD",
            "EDGE_THRESHOLD", "SQRT_PI_BY_2")},
        "tpl": {n: getattr(tpl, n) for n in ("QSTEP_PER_OCTAVE",
                                             "MAX_BOOST")},
        "quantizer": quantizer_constants(qz.build_quantizer),
    }


def constants_from_reference(d: dict) -> dict:
    """Check the reference's constants (the groups and names of
    ``own_constants``; sequences may come as lists) against the port's
    copies; any missing, extra or differing value raises.  Returns them
    as numpy arrays."""
    own = own_constants()
    if set(d) != set(own):
        raise ValueError(f"constant groups {sorted(d)} != {sorted(own)}")
    out = {}
    for group, values in d.items():
        mine = own[group]
        if set(values) != set(mine):
            diff = sorted(set(values) ^ set(mine))
            raise ValueError(f"{group}: constants differ in names: {diff}")
        out[group] = {}
        for k, v in values.items():
            a, b = np.asarray(v), np.asarray(mine[k])
            if a.shape != b.shape or not np.array_equal(a, b):
                raise ValueError(f"{group}/{k} differs from the port's copy")
            out[group][k] = a
    return out
