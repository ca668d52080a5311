"""Device resolution for the package's entry points.

Every entry point takes ``device=None``, and None means the GPU. A host
without one raises: nothing here moves work to the CPU behind the
caller's back. ``device="cpu"`` is the explicit CPU path (the plain
PyTorch versions of the kernels), which the tests use.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain PyTorch path explicitly"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
