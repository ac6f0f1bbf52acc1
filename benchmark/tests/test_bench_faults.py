"""``correct`` comes out false when the timed path is broken underneath:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a small size with each fault planted in the encoder after its
warm-up, and the controls (the program with a guarantee of the
configuration switched off) run through the same comparison."""
from __future__ import annotations

import numpy as np

from faults import FAULTS
from helpers import correct, drive, small_job

LD = "ld1080p-p8.streams4"
RA = "ra1080p-p8.titles4"


def test_the_sound_run_is_correct(ld_run):
    assert correct(ld_run[1])


def plant(name):
    def patch(ch):
        FAULTS[name](ch.enc)
    return patch


def test_a_stale_reconstruction_is_not_correct():
    run, checks = drive(small_job(LD), plant("stale_recon"))
    assert not correct(checks)
    assert checks["frame_mse_worst"]["value"] \
        > checks["frame_mse_worst"]["limit"]


def test_half_the_packets_left_out_is_not_correct():
    _, checks = drive(small_job(LD), plant("half_the_packets"))
    assert not correct(checks) and checks["stream_faults"]["value"] > 0


def test_an_altered_frame_header_is_not_correct():
    _, checks = drive(small_job(LD), plant("altered_header"))
    assert not correct(checks) and checks["stream_faults"]["value"] > 0


def test_an_altered_tile_data_byte_is_not_correct():
    """The reconstructions stay the encoder's own: only the decode of the
    tile data sees the altered token."""
    _, checks = drive(small_job(LD), plant("altered_tile_data"))
    assert not correct(checks) and checks["decode_mismatch"]["value"] > 0
    assert checks["stream_faults"]["value"] == 0
    for name in ("frame_mse_worst", "block_mse_worst"):
        assert checks[name]["value"] <= checks[name]["limit"]


def test_an_altered_reconstruction_block_is_not_correct():
    _, checks = drive(small_job(LD), plant("altered_block"))
    assert not correct(checks)
    assert checks["block_mse_worst"]["value"] \
        > checks["block_mse_worst"]["limit"]


def test_control_cdef_off_is_not_correct():
    """The configuration states CDEF on (preset 8): the program's own
    path with it off is the control."""
    _, checks = drive(small_job(LD, overrides={"cdef_level": 0}))
    assert not correct(checks) and checks["stream_faults"]["value"] > 0


def test_control_one_quantizer_step_coarser_is_not_correct():
    """Random access at qp 41, the next coarser quantizer than the
    configuration's qp 40: its non-reference pictures code at qindex
    164."""
    job = small_job(RA, seconds=0.1, measure=17, overrides={"qp": 41})
    job["traffic"]["title_pictures"] = 17
    run, checks = drive(job)
    assert not correct(checks)
    assert any("non-reference picture at base_q_idx 164" in f
               for f in run["results"][0]["faults"])


def test_the_sound_random_access_run_is_correct():
    job = small_job(RA, seconds=0.1, measure=17)
    job["traffic"]["title_pictures"] = 17
    run, checks = drive(job)
    res = run["results"][0]
    assert correct(checks), res["faults"]
    assert np.isfinite(checks["frame_mse_worst"]["value"])
    # the decode starts at the window's key frame and takes the hidden
    # pictures of the mini-GOP after it
    assert res["decode_from"] == 34 and len(res["decoded"]) == 5
    assert max(res["decoded"]) == 50
