"""``correct`` comes out false when the timed path is broken underneath:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a small size with each fault planted in the encoder after its
warm-up, and the controls (the program with a guarantee of the
configuration switched off) run through the same comparison."""
from __future__ import annotations

import types

import numpy as np
import pytest

from faults import FAULTS
from helpers import correct, drive, small_ld_job, small_ra_job


def test_the_sound_run_is_correct(ld_run):
    assert correct(ld_run[1])


def plant(name):
    def patch(ch):
        FAULTS[name](ch.enc)
    return patch


def test_a_stale_reconstruction_is_not_correct():
    run, checks = drive(small_ld_job(), plant("stale_recon"))
    assert not correct(checks)
    assert checks["frame_mse_worst"]["value"] \
        > checks["frame_mse_worst"]["limit"]


def test_half_the_packets_left_out_is_not_correct():
    _, checks = drive(small_ld_job(), plant("half_the_packets"))
    assert not correct(checks) and checks["stream_faults"]["value"] > 0


def test_an_altered_frame_header_is_not_correct():
    _, checks = drive(small_ld_job(), plant("altered_header"))
    assert not correct(checks) and checks["stream_faults"]["value"] > 0


def test_an_altered_tile_data_byte_is_not_correct():
    """The reconstructions stay the encoder's own: only the decode of the
    tile data sees the altered token."""
    _, checks = drive(small_ld_job(), plant("altered_tile_data"))
    assert not correct(checks) and checks["decode_mismatch"]["value"] > 0
    assert checks["stream_faults"]["value"] == 0
    for name in ("frame_mse_worst", "block_mse_worst"):
        assert checks[name]["value"] <= checks[name]["limit"]


def test_an_altered_reconstruction_block_is_not_correct():
    _, checks = drive(small_ld_job(), plant("altered_block"))
    assert not correct(checks)
    assert checks["block_mse_worst"]["value"] \
        > checks["block_mse_worst"]["limit"]


def test_control_cdef_off_is_not_correct():
    """The configuration states CDEF on (preset 8): the program's own
    path with it off is the control."""
    _, checks = drive(small_ld_job(overrides={"cdef_level": 0}))
    assert not correct(checks) and checks["stream_faults"]["value"] > 0


def test_control_one_quantizer_step_coarser_is_not_correct():
    """Random access at qp 41, the next coarser quantizer than the
    configuration's qp 40: its non-reference pictures code at qindex
    164."""
    run, checks = drive(small_ra_job(overrides={"qp": 41}))
    assert not correct(checks)
    assert any("non-reference picture at base_q_idx 164" in f
               for f in run["results"][0]["faults"])


def test_the_sound_random_access_run_is_correct(ra_run):
    run, checks = ra_run
    res = run["results"][0]
    assert correct(checks), res["faults"]
    assert np.isfinite(checks["frame_mse_worst"]["value"])
    # the decode starts at the window's key frame and takes the hidden
    # pictures of the mini-GOP after it
    assert res["decode_from"] == 34 and len(res["decoded"]) == 5
    assert max(res["decoded"]) == 50


def test_a_sound_10bit_random_access_channel_passes(ra_run, ra10_run):
    """Stated at 10 bits: 10-bit titles, every picture through the stream
    checks, the sample (a key frame, a hidden ALTREF, hidden compound
    pictures) decoded bit-exact, and the PSNR against the 10-bit peak
    near the 8-bit channel's: a wrong peak reads 12 dB off."""
    run, checks = ra10_run
    res = run["results"][0]
    assert correct(checks), res["faults"]
    assert checks["stream_faults"]["value"] == 0
    assert checks["decode_mismatch"]["value"] == 0
    assert res["decode_from"] == 34 and res["decoded"] == [34, 36, 38, 42,
                                                           50]
    assert abs(res["psnr_y_db"] - ra_run[0]["results"][0]["psnr_y_db"]) \
        < 1.5
    # the MSE readings are in 10-bit units, not 8-bit ones
    assert checks["frame_mse_worst"]["value"] \
        > 4 * ra_run[1]["frame_mse_worst"]["value"]


@pytest.mark.parametrize("bd, grey", [(8, 128), (10, 512)])
def test_the_grey_block_is_mid_grey_at_the_encoders_bit_depth(bd, grey):
    dt = np.uint8 if bd == 8 else np.uint16
    enc = types.SimpleNamespace(
        cfg=types.SimpleNamespace(encoder_bit_depth=bd),
        get_recon=lambda d: [np.zeros((128, 192), dt),
                             np.zeros((64, 96), dt), np.zeros((64, 96), dt)])
    FAULTS["altered_block"](enc)
    y, _, _ = enc.get_recon(3)
    assert y.dtype == dt and (y[:64, :64] == grey).all()
    assert not y[64:].any() and not y[:, 64:].any()


def test_a_sound_10bit_low_delay_channel_passes(ld_run, ld10_run):
    """The low-delay channel the 10-bit faults below are read against:
    stated at 10 bits it passes every check, its sample (the key frame
    and 6 P pictures) decoded bit-exact, its PSNR near the 8-bit
    channel's."""
    run, checks = ld10_run
    res = run["results"][0]
    assert correct(checks), res["faults"]
    assert res["faults"] == [] and res["decoded"] == list(range(7))
    assert checks["stream_faults"]["value"] == 0
    assert checks["decode_mismatch"]["value"] == 0
    assert abs(res["psnr_y_db"] - ld_run[0]["results"][0]["psnr_y_db"]) \
        < 1.5
    assert checks["frame_mse_worst"]["value"] \
        > 4 * ld_run[1]["frame_mse_worst"]["value"]


@pytest.mark.parametrize("fault, check", [
    ("stale_recon", "frame_mse_worst"),
    ("altered_block", "block_mse_worst"),
    ("altered_tile_data", "decode_mismatch"),
    ("cdef_off", "stream_faults")])
def test_faults_and_the_control_at_10_bits_are_not_correct(fault, check):
    """The 10-bit low-delay channel above, which codes its measured set
    and its decode sample whatever the host's load: each fault, and the
    control (CDEF off), fails the check that reads it, with the MSE
    limits in 10-bit units."""
    if fault == "cdef_off":
        run, checks = drive(small_ld_job(10, overrides={"cdef_level": 0}))
    else:
        run, checks = drive(small_ld_job(10), plant(fault))
    assert not correct(checks)
    assert checks[check]["value"] > checks[check]["limit"], checks
    if fault == "altered_tile_data":
        # as at 8 bits: the stream and the reconstructions pass, only the
        # decode of the tile data refuses, on a sample that was coded
        res = run["results"][0]
        assert checks["stream_faults"]["value"] == 0
        for name in ("frame_mse_worst", "block_mse_worst"):
            assert checks[name]["value"] <= checks[name]["limit"]
        assert not any("due" in f for f in res["faults"]), res["faults"]
