"""Where an entry point runs: the one rule every entry point of the port
shares (the solver's ``cholesky`` and engines, the LM stack's models)."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for an entry point: ``"cuda"`` unless the caller asks
    for another; a CUDA request without a card raises instead of running on
    the CPU (the message says how to ask for it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (want 'cuda' or 'cpu')")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host"
        )
    return dev
