"""Loaders for spec-constant tables and the per-frame adaptive CDF set.

The numeric data lives in ``data/av1_tables.npz`` (extracted from the
reference tree by tools/extract_ref_tables.py; the values are fixed by the
AV1 specification).  CDF arrays use the inverse-CDF + trailing counter
layout consumed by svt_av1_tpu.entropy.ec.

``FrameCdfs`` is the analog of the reference's per-frame ``FRAME_CONTEXT``
(Source/Lib/Common/Codec/EbCabacContextModel.h): one mutable copy per
frame (or per tile when tiles reset contexts), adapted symbol-by-symbol
during encode/decode and optionally stored for the next frame
(frame_end_cdf_update).
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_DATA = Path(__file__).parent / "data" / "av1_tables.npz"


@functools.cache
def _load() -> dict[str, np.ndarray]:
    with np.load(_DATA) as z:
        return {k: z[k] for k in z.files}


def table(name: str) -> np.ndarray:
    """Read-only spec table by reference name (e.g. 'default_scan_4x4')."""
    return _load()[name]


# --------------------------------------------------------------------------
# Quantizer lookups (AV1 spec 7.12.2; data: dc/ac_qlookup*_q3)
# --------------------------------------------------------------------------

def dc_q(qindex: int, bit_depth: int = 8) -> int:
    name = {8: "dc_qlookup_q3", 10: "dc_qlookup_10_q3", 12: "dc_qlookup_12_q3"}[bit_depth]
    return int(table(name)[np.clip(qindex, 0, 255)])


def ac_q(qindex: int, bit_depth: int = 8) -> int:
    name = {8: "ac_qlookup_q3", 10: "ac_qlookup_10_q3", 12: "ac_qlookup_12_q3"}[bit_depth]
    return int(table(name)[np.clip(qindex, 0, 255)])


# --------------------------------------------------------------------------
# Scan orders
# --------------------------------------------------------------------------

_SCAN_DIMS = {
    "4x4": (4, 4), "8x8": (8, 8), "16x16": (16, 16), "32x32": (32, 32),
    "4x8": (4, 8), "8x4": (8, 4), "8x16": (8, 16), "16x8": (16, 8),
    "16x32": (16, 32), "32x16": (32, 16), "4x16": (4, 16), "16x4": (16, 4),
    "8x32": (8, 32), "32x8": (32, 8),
}


@functools.cache
def scan_order(tx_w: int, tx_h: int, kind: str = "default") -> np.ndarray:
    """Scan table mapping scan position -> raster coefficient index.

    kind: 'default' (zigzag diagonal), 'mrow' (row-major), 'mcol'
    (column-major).  Transform sizes above 32 reuse the 32-point scan on
    the top-left 32x32 (AV1 zeroes high-frequency coeffs of 64-pt tx).
    The stored tables are indexed by (cols x rows) in the reference's
    WxH naming where W is the width used in its name.
    """
    w, h = min(tx_w, 32), min(tx_h, 32)
    key = f"{w}x{h}"
    if key not in _SCAN_DIMS:
        raise KeyError(f"no scan for {key}")
    return table(f"{kind}_scan_{key}")


# --------------------------------------------------------------------------
# Per-frame adaptive CDF context
# --------------------------------------------------------------------------

# (attribute name, source table) — every entry becomes a fresh mutable copy
# in FrameCdfs.  Coefficient CDFs are base-q-context dependent (index 0).
_FRAME_CDF_TABLES = {
    # partition / mode signaling
    "partition": "default_partition_cdf",
    "kf_y_mode": "default_kf_y_mode_cdf",
    "y_mode": "default_if_y_mode_cdf",
    "uv_mode": "default_uv_mode_cdf",
    "angle_delta": "default_angle_delta_cdf",
    "cfl_sign": "default_cfl_sign_cdf",
    "cfl_alpha": "default_cfl_alpha_cdf",
    "filter_intra_mode": "default_filter_intra_mode_cdf",
    "filter_intra": "default_filter_intra_cdfs",
    # tx signaling
    "tx_size": "default_tx_size_cdf",
    "txfm_partition": "default_txfm_partition_cdf",
    "intra_ext_tx": "default_intra_ext_tx_cdf",
    "inter_ext_tx": "default_inter_ext_tx_cdf",
    # skip / segmentation / delta-q
    "skip": "default_skip_cdfs",
    "skip_mode": "default_skip_mode_cdfs",
    "seg_tree": "default_seg_tree_cdf",
    "segment_pred": "default_segment_pred_cdf",
    "spatial_seg_tree": "default_spatial_pred_seg_tree_cdf",
    "delta_q": "default_delta_q_cdf",
    "delta_lf": "default_delta_lf_cdf",
    "delta_lf_multi": "default_delta_lf_multi_cdf",
    # inter mode signaling
    "newmv": "default_newmv_cdf",
    "zeromv": "default_zeromv_cdf",
    "refmv": "default_refmv_cdf",
    "drl": "default_drl_cdf",
    "inter_compound_mode": "default_inter_compound_mode_cdf",
    "intra_inter": "default_intra_inter_cdf",
    "comp_inter": "default_comp_inter_cdf",
    "comp_ref_type": "default_comp_ref_type_cdf",
    "uni_comp_ref": "default_uni_comp_ref_cdf",
    "single_ref": "default_single_ref_cdf",
    "comp_ref": "default_comp_ref_cdf",
    "comp_bwdref": "default_comp_bwdref_cdf",
    "compound_idx": "default_compound_idx_cdfs",
    "comp_group_idx": "default_comp_group_idx_cdfs",
    "interintra": "default_interintra_cdf",
    "interintra_mode": "default_interintra_mode_cdf",
    "wedge_interintra": "default_wedge_interintra_cdf",
    "compound_type": "default_compound_type_cdf",
    "wedge_idx": "default_wedge_idx_cdf",
    "motion_mode": "default_motion_mode_cdf",
    "seg_spatial": "default_spatial_pred_seg_tree_cdf",
    "obmc": "default_obmc_cdf",
    "switchable_interp": "default_switchable_interp_cdf",
    # loop restoration
    "switchable_restore": "default_switchable_restore_cdf",
    "wiener_restore": "default_wiener_restore_cdf",
    "sgrproj_restore": "default_sgrproj_restore_cdf",
    # screen content
    "palette_y_mode": "default_palette_y_mode_cdf",
    "palette_uv_mode": "default_palette_uv_mode_cdf",
    "palette_y_size": "default_palette_y_size_cdf",
    "palette_uv_size": "default_palette_uv_size_cdf",
    "palette_y_color_index": "default_palette_y_color_index_cdf",
    "palette_uv_color_index": "default_palette_uv_color_index_cdf",
    "intrabc": "default_intrabc_cdf",
}

# coefficient CDFs: tables indexed [q_ctx][...]; attribute gets the q_ctx
# slice at reset time.
_COEF_CDF_TABLES = {
    "txb_skip": "av1_default_txb_skip_cdfs",
    "dc_sign": "av1_default_dc_sign_cdfs",
    "eob_extra": "av1_default_eob_extra_cdfs",
    "eob_flag_16": "av1_default_eob_multi16_cdfs",
    "eob_flag_32": "av1_default_eob_multi32_cdfs",
    "eob_flag_64": "av1_default_eob_multi64_cdfs",
    "eob_flag_128": "av1_default_eob_multi128_cdfs",
    "eob_flag_256": "av1_default_eob_multi256_cdfs",
    "eob_flag_512": "av1_default_eob_multi512_cdfs",
    "eob_flag_1024": "av1_default_eob_multi1024_cdfs",
    "coeff_base_eob": "av1_default_coeff_base_eob_multi_cdfs",
    "coeff_base": "av1_default_coeff_base_multi_cdfs",
    "coeff_br": "av1_default_coeff_lps_multi_cdfs",
}


def get_qctx(base_qindex: int) -> int:
    """Quantizer context bucket for coefficient CDF init (AV1 spec
    init_coeff_cdfs: <=20, <=60, <=120, else)."""
    if base_qindex <= 20:
        return 0
    if base_qindex <= 60:
        return 1
    if base_qindex <= 120:
        return 2
    return 3


class FrameCdfs:
    """Mutable per-frame CDF set.

    Attributes are numpy uint16 arrays in icdf+counter layout, adapted in
    place by the symbol coder.  ``reset(base_qindex)`` loads spec
    defaults (key frames / primary_ref_none).
    """

    __slots__ = tuple(_FRAME_CDF_TABLES) + tuple(_COEF_CDF_TABLES) \
        + ("nmv", "ndv")

    def __init__(self, base_qindex: int = 0):
        self.reset(base_qindex)

    def reset(self, base_qindex: int) -> None:
        from .mv import NmvContext

        data = _load()
        for attr, name in _FRAME_CDF_TABLES.items():
            setattr(self, attr, data[name].copy())
        qctx = get_qctx(base_qindex)
        for attr, name in _COEF_CDF_TABLES.items():
            setattr(self, attr, data[name][qctx].copy())
        self.nmv = NmvContext()
        self.ndv = NmvContext()       # intrabc DV context (ndvc)

    def copy(self) -> "FrameCdfs":
        import copy as _copy

        out = object.__new__(FrameCdfs)
        for attr in self.__slots__:
            v = getattr(self, attr)
            setattr(out, attr, v.copy() if isinstance(v, np.ndarray)
                    else _copy.deepcopy(v))
        return out

    def zero_counters(self) -> None:
        """Zero every row's adaptation counter (the element right after
        the row's icdf tail zero at position nsyms-1) — the reference
        resets symbol counters before saving a frame context for
        primary-ref chaining (av1_reset_cdf_symbol_counters analog),
        so the next frame adapts at the fresh-context rate."""
        def _zero(arr: np.ndarray) -> None:
            flat = arr.reshape(-1, arr.shape[-1])
            if flat.shape[1] < 2:
                return
            # icdf rows are positive until icdf[nsyms-1] == 0; the
            # counter sits at nsyms (rows narrower than the table width
            # are zero-padded, making the write a no-op there)
            nz = (flat == 0).argmax(axis=1)
            idx = np.minimum(nz + 1, flat.shape[1] - 1)
            flat[np.arange(flat.shape[0]), idx] = 0

        for attr in self.__slots__:
            v = getattr(self, attr)
            if isinstance(v, np.ndarray):
                _zero(v)
        for nmv in (self.nmv, self.ndv):
            _zero(nmv.joints)
            for comp in nmv.comps:
                for name in vars(comp):
                    cv = getattr(comp, name)
                    if isinstance(cv, np.ndarray):
                        _zero(cv)
                    elif isinstance(cv, (list, tuple)):
                        for item in cv:
                            if isinstance(item, np.ndarray):
                                _zero(item)

    def eob_flag(self, eob_pt_alphabet_size_log2: int) -> np.ndarray:
        """eob_pt cdf table for a txsize with 2^k max eob."""
        return getattr(self, f"eob_flag_{1 << eob_pt_alphabet_size_log2}")
