"""The one place where a configured device name becomes a torch device."""

import torch


def resolve_device(name, owner: str = "device") -> torch.device:
    """torch.device(name); a CUDA device raises RuntimeError when no card is
    present, so nothing runs on the CPU unless the caller asked for it."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner}={str(name)!r} but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path")
    return dev
