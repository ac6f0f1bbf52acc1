"""Explicit device resolution for the port's entry points.

Entry points take ``device``; without one they run on CUDA and raise when
CUDA is absent (a CPU run is asked for explicitly, as the CPU tests do).
TF32 is switched off: the directional intra predictors rely on float32
matrix products staying exact integers, and the intra cost model is
held to the float32 reference.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the type of a source plane on the device, by bit depth: 8-bit samples as
# uint8, 10-bit ones as int16; K1 and K4's search have a form for each
SAMPLE_DTYPES = {8: torch.uint8, 10: torch.int16}


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "svt_av1_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev
