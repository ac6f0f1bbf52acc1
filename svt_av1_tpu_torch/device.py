"""Explicit device resolution for the port's entry points.

Entry points take ``device``; without one they run on CUDA and raise when
CUDA is absent (a CPU run is asked for explicitly, as the CPU tests do).
TF32 is switched off: the directional intra predictors rely on float32
matrix products staying exact integers, and the intra cost model is
held to the float32 reference.
"""
from __future__ import annotations

import torch

from .profiling import current_timer

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


def to_device(t: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """``t.to(device)``, or ``t.to(device=device, dtype=dtype)`` with a
    dtype, for a host tensor ``t``.  A copy from the host to another
    device is timed as the stage ``upload`` of the running encoder call
    and counted with the bytes that land on the device."""
    timer = current_timer()
    if timer is None or t.device.type != "cpu" \
            or torch.device(device).type == "cpu":
        return t.to(device) if dtype is None \
            else t.to(device=device, dtype=dtype)
    with timer.transfer("upload") as tr:
        out = t.to(device) if dtype is None \
            else t.to(device=device, dtype=dtype)
        tr.nbytes = out.numel() * out.element_size()
    return out


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``.  A copy from a device is timed as the stage
    ``readback`` of the running encoder call, the wait for the work
    queued before it included, and counted with its bytes."""
    timer = current_timer()
    if timer is None or t.device.type == "cpu":
        return t.cpu()
    with timer.transfer("readback") as tr:
        out = t.cpu()
        tr.nbytes = out.numel() * out.element_size()
    return out
