"""Device choice and kernel routing.

A kernel wrapper routes by the device of the tensors it is given, and only
by that: a CPU tensor takes the kernel's plain PyTorch version, a CUDA
tensor launches the kernel (or raises), and any other device raises.
Nothing falls back from the card to the CPU.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "resolve_devices", "on_device", "kernel_route"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """A torch.device the receiver can run on: the card unless the caller
    names another (``None`` is ``"cuda"``). Raises for CUDA without a card
    and for any device other than CPU or CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False")
        if dev.index is None:       # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cpu' or 'cuda'")
    return dev


def resolve_devices(devices=None) -> list[torch.device]:
    """The device list of a multi-device entry point: every visible CUDA
    device when ``devices`` is None (raising where there is none), else the
    caller's devices, each checked by ``resolve_device``. A device may be
    named more than once (several replicas on one card)."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", k)
                for k in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("devices must name at least one device")
    return devs


def on_device(device: torch.device):
    """Context in which ``device`` is the current CUDA device (kernels and
    streams follow it); nothing to set for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


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
