"""Explicit device resolution for the PyTorch port (counterpart of
``oscillink_tpu/utils/platform.py``).

Entry points run on ``cuda`` unless the caller names another device.  There
is no silent fallback: asking for CUDA on a machine without it raises, so a
run that was meant for the card can never quietly finish on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the ``torch.device`` to run on (``cuda`` when ``device`` is None).

    On CUDA this also turns TF32 off for matmuls and cuDNN: the similarity
    scan is f32 at full precision in the reference (``precision=HIGHEST``),
    and TF32's 10-bit mantissa would drift ~1e-3 into neighbour selection
    and state signatures.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "oscillink_tpu_torch: CUDA was requested (the default) but "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
