from .bits import BitWriter, BitReader, leb128_encode, leb128_decode

__all__ = ["BitWriter", "BitReader", "leb128_encode", "leb128_decode"]
