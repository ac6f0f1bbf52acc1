"""svt_av1_tpu_torch — the PyTorch/CUDA port of the svt_av1_tpu AV1 codec.

The JAX package ``svt_av1_tpu`` stays the reference; this package imports
nothing of it (nor jax).  Host-only modules (bitstream, entropy coding,
I/O, the conformant frame walker and the native C tile coder) are copies;
the device programs run as hand-written CUDA kernels for Hopper
(kernels/csrc/), each beside a plain PyTorch version that CPU tensors
take.

Public names (from ``api``): ``Encoder`` and ``encode_ivf`` (every
configuration the configuration check accepts: presets -2 to 8, 8 and 10
bits, 4:2:0, all-intra, low-delay P and random access, super-resolution,
film grain, two-pass statistics, a caller's decider), ``Decoder`` and
``decode_ivf`` (host tile walk, deblocking and CDEF on the device),
``ApiError`` and ``ErrorCode``.  The command-line app is ``python -m
svt_av1_tpu_torch.app``; the stripe step of a frame's device programs is
``parallel.dryrun.dryrun_stripes``.
"""

__version__ = "0.1.0"

_API = ("ApiError", "Decoder", "Encoder", "ErrorCode", "decode_ivf",
        "encode_ivf")
__all__ = list(_API)


def __getattr__(name):
    # the public names load the codec on first use, not on import
    if name in _API:
        from . import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
