"""Accelerator managers (the port's counterpart of ray_tpu/accelerators):
the NVIDIA GPU manager under the resource name "GPU"."""

from ray_tpu_torch.accelerators.accelerator import AcceleratorManager
from ray_tpu_torch.accelerators.gpu import NvidiaGPUAcceleratorManager

_MANAGERS = {"GPU": NvidiaGPUAcceleratorManager}


def get_accelerator_manager(resource_name: str):
    return _MANAGERS.get(resource_name)


def get_all_accelerator_managers():
    return dict(_MANAGERS)


__all__ = ["AcceleratorManager", "NvidiaGPUAcceleratorManager",
           "get_accelerator_manager", "get_all_accelerator_managers"]
