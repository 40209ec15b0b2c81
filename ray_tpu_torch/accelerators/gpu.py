"""NVIDIA GPU accelerator manager — card count, type and visibility.

The port's counterpart of ray_tpu/accelerators/tpu.py::TPUAcceleratorManager
(reference: python/ray/_private/accelerators/nvidia_gpu.py): the resource
"GPU", the visible-ids variable CUDA_VISIBLE_DEVICES, the count from
``torch.cuda.device_count()`` (which honours that variable), the type from
``torch.cuda.get_device_name``, whole cards only. A GPU host has no pod
slice, so there is no slice-head resource.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch

from ray_tpu_torch.accelerators.accelerator import AcceleratorManager

GPU_RESOURCE_NAME = "GPU"
CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
# test/dev override, the counterpart of RAY_TPU_FAKE_CHIPS: the CPU tests
# do resource math against this many cards without one
FAKE_GPUS_ENV = "RAY_TPU_FAKE_GPUS"


class NvidiaGPUAcceleratorManager(AcceleratorManager):
    @staticmethod
    def get_resource_name() -> str:
        return GPU_RESOURCE_NAME

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> str:
        return CUDA_VISIBLE_DEVICES_ENV

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        fake = os.environ.get(FAKE_GPUS_ENV)
        if fake:
            return int(fake)
        return torch.cuda.device_count()

    @staticmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        """The card's name, e.g. "NVIDIA H100 80GB HBM3"; None without one."""
        if not torch.cuda.is_available():
            return None
        return torch.cuda.get_device_name(0)

    @staticmethod
    def get_current_process_visible_accelerator_ids() -> Optional[List[str]]:
        v = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
        if v is None:
            return None
        if v == "":
            return []
        return v.split(",")

    @staticmethod
    def set_current_process_visible_accelerator_ids(ids: List[str]) -> None:
        os.environ[CUDA_VISIBLE_DEVICES_ENV] = ",".join(str(i) for i in ids)

    @staticmethod
    def validate_resource_request_quantity(quantity: float) -> Tuple[bool, str]:
        if quantity != int(quantity):
            return False, "GPU resource quantity must be whole cards"
        return True, ""
