"""A frozen copy of the JAX package's host AV1 decoder (svt_av1_tpu:
``api.Decoder`` and ``Dpb``, ``pipeline/frame_codec.py``'s symbol reader
and walk, ``bitstream/``, ``entropy/``, and the host paths of ``ops/``),
plain Python and NumPy.  Its device programs are left out: the copy never
imports JAX, the JAX package or the port.  The JAX package's end-to-end
tests hold this decoder bit-exact against SVT-AV1's own SvtAv1DecApp
(``tests/test_e2e.py``).  ``decoder.Decoder`` is the entry point."""
