"""The reference decoder (``av1dec/``) and the decode half of the
comparison (``decode_check.py``), on streams the port codes on the CPU."""
from __future__ import annotations

import ast

import numpy as np
import pytest

import decode_check as dc
import reference as ref
from helpers import ROOT, small_job

STREAM = {}


@pytest.fixture(scope="module", autouse=True)
def stream():
    """A low-delay stream of a few pictures, its packets, per-packet
    units and reconstructions kept."""
    from channel import Channel, guarantees

    job = small_job("ld1080p-p8.streams4", seconds=0.5)
    ch = Channel(job)
    ch.window(0.0)
    units = []
    faults, _ = ref.check_stream(ch.packets, guarantees(job["config"]
                                                        ["encoder"]), units)
    assert faults == []
    STREAM.update(packets=ch.packets, units=units,
                  recons={d: ch.enc.get_recon(d)
                          for d in range(ch.enc.frame_count)})
    return STREAM


@pytest.mark.parametrize("native", [True, False], ids=["c", "python"])
def test_the_decoder_reproduces_every_reconstruction(native, monkeypatch):
    from av1dec.entropy import native_dec

    if native:
        native_dec.build()
    monkeypatch.setattr(native_dec, "ENABLED", native)
    faults, pictures = dc.decode_sample(
        STREAM["packets"], STREAM["units"], 0, len(STREAM["packets"]),
        STREAM["recons"].get)
    assert faults == []
    assert sorted(pictures) == list(range(len(STREAM["packets"])))


def test_the_c_symbol_decoder_is_the_one_in_use():
    from av1dec.entropy import native_dec

    native_dec.build()
    dec = native_dec.make_range_decoder(b"\x00" * 8)
    assert isinstance(dec, native_dec.NativeRangeDecoder)


def test_a_tile_data_byte_altered_is_found():
    pkts = list(STREAM["packets"])
    pkt = bytearray(pkts[1])
    pkt[3 * len(pkt) // 4] ^= 0x5A
    pkts[1] = bytes(pkt)
    faults, _ = dc.decode_sample(pkts, STREAM["units"], 0, len(pkts),
                                 STREAM["recons"].get)
    assert faults and "packet 1" in faults[0]


def test_a_sample_past_the_end_is_a_fault():
    n = len(STREAM["packets"])
    faults, pictures = dc.decode_sample(STREAM["packets"], STREAM["units"],
                                        0, n + 2, STREAM["recons"].get)
    assert faults == [f"{n} packets to decode, {n + 2} due"]
    assert len(pictures) == n


def test_the_sample_starts_at_a_key_frame_in_the_window():
    units = [dict(display=d, key=d % 34 == 0) for d in range(140)]
    starts = {dc.sample_start(units, 17, 5, seed, 0) for seed in range(9)}
    assert starts == {34, 68, 102}
    # no later key frame (low delay): the stream's first packet
    assert dc.sample_start(units[:30], 5, 7, 1, 2) == 0
    # a key frame too near the end for the whole sample is passed over
    assert dc.sample_start(units[:38], 17, 5, 0, 0) == 0


def test_first_difference_names_the_plane_and_sample():
    a = tuple(np.zeros(s, np.uint8) for s in ((4, 4), (2, 2), (2, 2)))
    b = (a[0], a[1].copy(), a[2])
    b[1][1, 0] = 3
    assert dc.first_difference(a, a) is None
    assert dc.first_difference(a, b) == ("plane 1: 1 samples differ, first "
                                         "at (1, 0): 0 against 3")


def test_the_decoder_imports_nothing_of_the_program():
    for path in sorted((ROOT / "benchmark" / "av1dec").rglob("*.py")) + [
            ROOT / "benchmark" / "decode_check.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in (
                    "svt_av1_tpu_torch", "torch", "jax", "svt_av1_tpu"), \
                    (path, name)
