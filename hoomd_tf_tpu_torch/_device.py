"""The port's device rule: every entry point that makes tensors runs on
the CUDA card unless the caller names another device, and raises when
there is no card rather than quietly taking the CPU."""

import torch


def resolve_device(device, what):
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device and raises when there is none (``what`` names the caller in
    the message)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on the CUDA card by default and found none; "
                "pass device='cpu' to run on the CPU")
        device = "cuda"
    # resolved ("cuda" -> "cuda:0") so device checks compare exactly
    return torch.empty(0, device=device).device
