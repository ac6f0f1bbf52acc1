"""Host ops (copies of svt_av1_tpu.ops) and the ported device ops
(omd, dlf, cdef, filter_chain) with their CUDA kernel wrappers."""
