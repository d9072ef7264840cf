"""Devices: ``cpu`` and ``gpu`` (CUDA).

Port of ``heat_tpu/core/devices.py``.  The default device is the GPU.  On
a machine without a CUDA device the default does not fall back to the CPU:
:func:`get_device` raises until the caller asks for the CPU explicitly,
with :func:`use_device` or a ``device="cpu"`` argument, so a run never
lands on the CPU by accident.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["Device", "cpu", "gpu", "get_device", "use_device", "sanitize_device"]


class Device:
    """A device class arrays can live on: ``"cpu"`` or ``"gpu"``."""

    def __init__(self, device_type: str):
        self.__device_type = device_type

    @property
    def device_type(self) -> str:
        return self.__device_type

    def __repr__(self) -> str:
        return f"device({self.__device_type!r})"

    def __str__(self) -> str:
        return self.__device_type


cpu = Device("cpu")
gpu = Device("gpu")

_NAMES = {"cpu": cpu, "gpu": gpu, "cuda": gpu}
_default: Optional[Device] = None


def get_device() -> Device:
    """The process-wide default device: the one set by :func:`use_device`,
    else the GPU.  Raises when no CUDA device is present and the CPU was
    not asked for."""
    if _default is not None:
        return _default
    if torch.cuda.is_available():
        return gpu
    raise RuntimeError(
        "heat_tpu_torch runs on a CUDA device by default and none is "
        "available; call heat_tpu_torch.use_device('cpu') or pass "
        "device='cpu' to run on the CPU"
    )


def use_device(device: Optional[Union[str, Device]] = None) -> None:
    """Set the process-wide default device (``None`` restores the GPU
    default)."""
    global _default
    _default = None if device is None else sanitize_device(device)


def sanitize_device(device: Optional[Union[str, Device, torch.device]]) -> Device:
    """Normalize a device argument; ``None`` means the default device."""
    if device is None:
        return get_device()
    if isinstance(device, Device):
        return device
    if isinstance(device, torch.device):
        device = device.type
    name = str(device).strip().lower().split(":")[0]
    if name in _NAMES:
        return _NAMES[name]
    raise ValueError(f"Unknown device {device!r}: expected 'cpu' or 'gpu'")
