"""Faults planted in a channel's encoder after its warm-up, for the
comparison to refuse: the CPU tests drive them at a small size, and
``control.py --fault`` reads them on the card at the cell's size.  The
benchmark's own runs never plant one."""
from __future__ import annotations


def stale_recon(enc) -> None:
    """A step that returns its state unchanged: each picture's
    reconstruction is the one before it."""
    keep = enc.get_recon
    enc.get_recon = lambda d: keep(max(d - 1, 0))


def half_the_packets(enc) -> None:
    """Half of the work left out: every other packet is lost."""
    keep = enc.send_picture
    count = [0]

    def send(planes):
        out = []
        for p in keep(planes):
            count[0] += 1
            if count[0] % 2:
                out.append(p)
        return out
    enc.send_picture = send


def altered_header(enc) -> None:
    """An answer altered where it is produced: one bit of each frame
    OBU's first payload byte (its frame type)."""
    import reference

    def flip(packet: bytes) -> bytes:
        obus = reference.split_obus(packet)
        pkt = bytearray(packet)
        pkt[len(pkt) - len(obus[-1][1])] ^= 0x40
        return bytes(pkt)
    keep = enc.send_picture
    enc.send_picture = lambda planes: [flip(p) for p in keep(planes)]


def altered_tile_data(enc) -> None:
    """A token altered where it is produced: one byte of the tile data of
    each frame OBU, three quarters into its payload (past the header),
    with the reconstruction left as the encoder made it."""
    import reference

    def flip(packet: bytes) -> bytes:
        obu_type, payload = reference.split_obus(packet)[-1]
        if obu_type != reference.OBU_FRAME:
            return packet
        pkt = bytearray(packet)
        pkt[len(pkt) - len(payload) + 3 * len(payload) // 4] ^= 0x5A
        return bytes(pkt)
    keep = enc.send_picture
    enc.send_picture = lambda planes: [flip(p) for p in keep(planes)]


def altered_block(enc) -> None:
    """An answer altered where it is produced: the top-left 64x64 luma
    block of each reconstruction set to mid-grey."""
    keep = enc.get_recon

    def get(d):
        y, u, v = keep(d)
        y = y.copy()
        y[:64, :64] = 128
        return y, u, v
    enc.get_recon = get


FAULTS = {f.__name__: f for f in (stale_recon, half_the_packets,
                                  altered_header, altered_tile_data,
                                  altered_block)}
