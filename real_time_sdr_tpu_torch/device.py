"""Device choice and kernel routing.

A kernel wrapper routes by the device of the tensors it is given, and only
by that: a CPU tensor takes the kernel's plain PyTorch version, a CUDA
tensor launches the kernel (or raises), and any other device raises.
Nothing falls back from the card to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "kernel_route"]


def resolve_device(device: str | torch.device = "cpu") -> torch.device:
    """A torch.device the receiver can run on; raises for CUDA without a
    card and for any device other than CPU or CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cpu' or 'cuda'")
    return dev


def kernel_route(*tensors: torch.Tensor) -> str:
    """'plain' when every tensor lies on the CPU, 'cuda' when every tensor
    lies on one CUDA device; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return "plain"
    if dev.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel route for device {dev}")
