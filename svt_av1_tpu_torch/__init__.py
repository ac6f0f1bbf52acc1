"""svt_av1_tpu_torch — the PyTorch/CUDA port of the svt_av1_tpu AV1 encoder.

The JAX package ``svt_av1_tpu`` stays the reference; this package imports
nothing of it (nor jax).  Host-only modules (bitstream, entropy coding,
I/O, the conformant frame walker and the native C tile coder) are copies;
the device programs of the ported paths run as hand-written CUDA kernels
for Hopper (kernels/csrc/), each beside a plain PyTorch version that CPU
tensors take.

Ported slices: preset 8, 8-bit 4:2:0, all-intra and low-delay P (one key
frame, then P frames); api.Encoder raises NotImplementedError outside
them.
"""

__version__ = "0.1.0"
