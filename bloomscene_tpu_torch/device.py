"""Device selection shared by the entry points, and the small constant
tensors that a captured training step reads."""
from __future__ import annotations

import numpy as np
import torch

_CONSTANTS: dict = {}


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent. There is no fallback: a CPU run is the caller's explicit choice.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def strict_fp32(dev: torch.device) -> None:
    """Keep float32 products in full float32 on the card: TF32 keeps about
    three decimal digits, too few to hold the heads against the JAX
    reference. Sets ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False (process-wide)."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def device_constant(values: np.ndarray, device) -> torch.Tensor:
    """``torch.as_tensor(values, device=device)``, made once for each
    (contents, dtype, shape, device) and kept. The copy to the card happens
    on the first call, so a CUDA graph captured after an eager step reads
    the kept tensor: a host-to-device copy cannot be captured. Callers must
    not write into the returned tensor."""
    arr = np.ascontiguousarray(values)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), str(torch.device(device)))
    out = _CONSTANTS.get(key)
    if out is None:
        out = _CONSTANTS[key] = torch.from_numpy(arr.copy()).to(device)
    return out
