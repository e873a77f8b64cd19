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


def device_for(x, device, what):
    """The device of an entry point's input ``x``: a tensor keeps its own
    unless ``device`` names one; host data goes to ``device``, by default
    the CUDA card (:func:`resolve_device`)."""
    if device is None and torch.is_tensor(x):
        return x.device
    return resolve_device(device, what)


def to_device(t, device):
    """``t`` on ``device`` (a mesh shard's copy): a copy to a card is
    queued without blocking the host, the card orders it before its
    readers; a copy to the host blocks, since the host reads it next."""
    device = torch.device(device)
    return t.to(device, non_blocking=device.type == "cuda")
