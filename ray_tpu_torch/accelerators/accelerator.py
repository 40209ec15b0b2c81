"""Accelerator plugin interface (copy of ray_tpu/accelerators/accelerator.py).

Reference: python/ray/_private/accelerators/accelerator.py (AcceleratorManager
ABC). The NVIDIA GPU is the port's implementation (gpu.py); the interface
stays open for others (the reference ships nvidia/amd/neuron/hpu/npu
backends).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional


class AcceleratorManager(ABC):
    @staticmethod
    @abstractmethod
    def get_resource_name() -> str: ...

    @staticmethod
    @abstractmethod
    def get_visible_accelerator_ids_env_var() -> str: ...

    @staticmethod
    @abstractmethod
    def get_current_node_num_accelerators() -> int: ...

    @staticmethod
    @abstractmethod
    def get_current_node_accelerator_type() -> Optional[str]: ...

    @staticmethod
    @abstractmethod
    def get_current_process_visible_accelerator_ids() -> Optional[List[str]]: ...

    @staticmethod
    @abstractmethod
    def set_current_process_visible_accelerator_ids(ids: List[str]) -> None: ...

    @staticmethod
    def validate_resource_request_quantity(quantity: float) -> tuple:
        return (True, "")

    @staticmethod
    def get_current_node_additional_resources() -> dict:
        return {}
