"""The plain reference: the AV1 header syntax it parses, the structure it
holds a stream to, and its distortion arithmetic, on streams the port
codes on the CPU."""
from __future__ import annotations

import numpy as np
import pytest

import reference as ref
from helpers import small_job


def test_a_sound_low_delay_channel_passes(ld_run):
    run, checks = ld_run
    res = run["results"][0]
    assert res["faults"] == [] and checks["stream_faults"]["value"] == 0
    assert res["checked"] >= 6 and res["stream_bytes"] > 0
    assert res["n_decode_faults"] == 0 and res["decoded"] == list(range(7))
    assert 25 < res["psnr_y_db"] < 60


def test_the_sequence_header_parses():
    seq = ref.parse_sequence_header(ref.split_obus(PACKETS[0])[1][1])
    assert (seq["width"], seq["height"], seq["bit_depth"]) == (192, 128, 8)
    assert seq["sb128"] == 1 and seq["cdef"] == 1 and seq["mono"] == 0


PACKETS = []


@pytest.fixture(scope="module", autouse=True)
def packets():
    """A low-delay stream of 6 pictures, its packets kept."""
    from channel import Channel

    job = small_job("ld1080p-p8.streams4", seconds=0.5)
    ch = Channel(job)
    ch.window(0.0)
    PACKETS[:] = ch.packets
    return ch.packets


def guar(**kw):
    g = dict(width=192, height=128, bit_depth=8, sb128=1, qp=40,
             key_interval=0, reorder=False)
    g.update(kw)
    return g


def test_the_stream_checks_pass_and_count_every_picture():
    faults, shown = ref.check_stream(PACKETS, guar())
    assert faults == []
    assert [d for d, _ in shown] == list(range(len(PACKETS)))
    assert shown[-1][1] == sum(len(p) for p in PACKETS)


@pytest.mark.parametrize("what, kw", [
    ("width", dict(width=256)), ("bit depth", dict(bit_depth=10)),
    ("quantizer", dict(qp=20)), ("key period", dict(key_interval=2))])
def test_a_stream_that_breaks_a_guarantee_fails(what, kw):
    faults, _ = ref.check_stream(PACKETS, guar(**kw))
    assert faults, what


def test_a_dropped_packet_shows_one_picture_fewer():
    # the channel holds the count of shown pictures to the coded ones
    _, shown = ref.check_stream(PACKETS[:2] + PACKETS[3:], guar())
    assert len(shown) == len(PACKETS) - 1


def test_a_cut_packet_fails():
    cut = PACKETS[:1] + [PACKETS[1][: len(PACKETS[1]) // 2]] + PACKETS[2:]
    faults, _ = ref.check_stream(cut, guar())
    assert any("past the end" in f for f in faults)


def test_a_frame_header_bit_altered_fails():
    pkt = bytearray(PACKETS[2])
    obus = ref.split_obus(bytes(pkt))
    # the frame OBU's first payload byte: show_existing_frame, frame_type
    at = len(pkt) - len(obus[-1][1])
    pkt[at] ^= 0x40
    faults, _ = ref.check_stream(PACKETS[:2] + [bytes(pkt)] + PACKETS[3:],
                                 guar())
    assert faults


def test_leb128_and_bits():
    assert ref.leb128(bytes([0xE5, 0x8E, 0x26]), 0) == (624485, 3)
    r = ref.Bits(bytes([0b10110000]))
    assert r.f(1) == 1 and r.f(3) == 0b011 and r.su(2) == 0
    with pytest.raises(ref.SyntaxFault):
        ref.Bits(b"").f(1)


def test_block_mse_covers_partial_blocks():
    a = np.zeros((130, 70), np.uint8)
    b = a.copy()
    b[128:, 64:] = 10                      # the 2x6 corner block
    m = ref.block_mse(b, a, 64)
    assert m.shape == (3, 2)
    assert m[2, 1] == 100 and m.sum() == 100


def test_check_recon_and_psnr():
    src = {0: tuple(np.full(s, 100, np.uint8) for s in
                    ((64, 64), (32, 32), (32, 32)))}
    rec = {0: (src[0][0] + 2, src[0][1], src[0][2])}
    q = ref.check_recon(rec, lambda d: src[d], 32, 8)
    assert q[0]["mse"] == 4 and q[0]["block"] == 4
    assert q[0]["psnr"] == pytest.approx(10 * np.log10(255 ** 2 / 4))
    assert ref.psnr(0.0) == 100.0
    assert ref.qindex_of_qp(40) == 160 and ref.qindex_of_qp(63) == 255


@pytest.mark.parametrize("bd, peak", [(8, 255), (10, 1023)])
def test_psnr_and_the_sentinel_take_the_bit_depths_peak(bd, peak):
    assert ref.worst_mse(bd) == peak * peak
    assert ref.psnr(4.0, bd) == pytest.approx(10 * np.log10(peak ** 2 / 4))
    assert ref.psnr(ref.worst_mse(bd), bd) == 0.0
    assert ref.psnr(0.0, bd) == 100.0
    # the same error in 10-bit units (4x the samples, 16x the MSE) reads
    # the same PSNR
    assert ref.psnr(16 * 4.0, 10) == pytest.approx(ref.psnr(4.0, 8), abs=0.03)
    shapes = ((64, 64), (32, 32), (32, 32))
    src = tuple(np.full(s, 100, np.uint16) for s in shapes)
    rec = (np.full((64, 32), 100, np.uint16), src[1], src[2])
    q = ref.check_recon({0: rec}, lambda d: src, 32, bd)
    assert q[0] == dict(mse=peak * peak, block=peak * peak, psnr=0.0)
