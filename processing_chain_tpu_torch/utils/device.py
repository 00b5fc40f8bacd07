"""Device resolution for the port (counterpart of
processing_chain_tpu/utils/device.py:121-150).

Entry points run on the card unless the caller asks otherwise:
`device=None` means `cuda:0`, and resolving it on a host without CUDA
raises. There is deliberately no silent CPU fallback (the reference's
`ensure_backend` degrades to the CPU backend): a render that quietly ran
on the host would be orders of magnitude slower and could be mistaken
for a device measurement. Callers that want the CPU pass `device="cpu"`.
"""

from __future__ import annotations

import torch

from .log import get_logger


class DeviceError(RuntimeError):
    """The requested device does not exist on this host."""


def resolve_device(device=None) -> torch.device:
    """`None` → `cuda:0`; anything else → `torch.device(device)`, checked
    to exist when it is a CUDA device."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceError(
                f"device {dev} requested but CUDA is not available on this "
                "host; pass device='cpu' to run the plain CPU path"
            )
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise DeviceError(
                f"device index {index} out of range: "
                f"{torch.cuda.device_count()} device(s) visible"
            )
        dev = torch.device("cuda", index)
    return dev


def device_count() -> int:
    """Number of visible CUDA devices (0 on a host without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def select_device(index) -> torch.device:
    """The `-g N` device pin: N → `cuda:N`, checked against the visible
    devices (same out-of-range message as the reference). `None` or a
    negative index means the default device, `cuda:0`."""
    if index is None or index < 0:
        return resolve_device(None)
    n = device_count()
    if index >= n:
        raise DeviceError(
            f"device index {index} out of range: {n} device(s) visible"
        )
    get_logger().info("pinning device work to cuda:%d", index)
    return torch.device("cuda", index)
