"""RDT — direct tensor transport between actors, device-aware (PyTorch
port of ray_tpu/experimental/rdt.py).

Reference: python/ray/experimental/rdt/collective_tensor_transport.py:34
and nixl_tensor_transport.py:94 — the reference moves GPU tensors
actor-to-actor through NCCL collectives or NIXL, bypassing the object
store's pickle path. This module is the same-host, cross-process path
of the JAX package, through the host: a ``DeviceTensorChannel`` is a
fixed-shape shared-memory slot (``TensorChannel``'s seqlock protocol).
The writer copies the producer's CUDA tensor off the card into a pinned
staging buffer, then into the slot (no pickle); the reader copies the
slot into its own pinned buffer and onto its device: the card it was
given or leased (``device=None``), the CPU only where the caller asks.
bfloat16 rides as a uint16 view of its bits (numpy has no bf16 wire
type), so the hand-off is bit-exact.

A hand-off costs one device-to-host copy, two host memcpys and one
host-to-device copy, with backpressure from the reader's ack. CUDA IPC
(the reader mapping the writer's device memory) would skip the host; it
is a later speed item (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch import default_device
from ray_tpu_torch.experimental.channel import TensorChannel, TensorChannelReader

_BF16_WIRE = "uint16"  # numpy-safe carrier for bfloat16 payloads


def _dtype_name(dtype) -> str:
    """"float32", torch.float32 and np.float32 all name float32."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return "bfloat16" if dtype == "bfloat16" else str(np.dtype(dtype))


def _wire_dtype(dtype_str: str) -> Tuple[str, bool]:
    if dtype_str == "bfloat16":
        return _BF16_WIRE, True
    return dtype_str, False


def _torch_dtype(wire: str) -> torch.dtype:
    # the wire's bits as a torch dtype of the same width (torch's uint16
    # has few ops; int16 carries the same bits)
    return torch.int16 if wire == _BF16_WIRE else getattr(torch, wire)


def _pinned(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class DeviceTensorChannel:
    """Fixed-shape device-tensor slot between two local actors."""

    def __init__(self, shape, dtype="float32", num_readers: int = 1,
                 name: Optional[str] = None):
        self.shape = tuple(shape)
        self.dtype = _dtype_name(dtype)
        wire, self._is_bf16 = _wire_dtype(self.dtype)
        self._ch = TensorChannel(shape, wire, num_readers=num_readers,
                                 name=name)
        self.name = self._ch.name
        self._staging: Optional[torch.Tensor] = None

    def write(self, tensor, timeout: Optional[float] = 10.0) -> None:
        """``tensor``: a torch.Tensor of the channel's shape and dtype, on
        a card (staged through pinned host memory) or on the CPU; or an
        ndarray of a numpy dtype."""
        if isinstance(tensor, torch.Tensor):
            if _dtype_name(tensor.dtype) != self.dtype or tuple(tensor.shape) != self.shape:
                raise ValueError(
                    f"expected {self.shape} {self.dtype}, got "
                    f"{tuple(tensor.shape)} {tensor.dtype}")
            if self._is_bf16:
                tensor = tensor.view(torch.int16)
            if tensor.is_cuda:
                if self._staging is None:
                    self._staging = _pinned(self.shape, tensor.dtype)
                self._staging.copy_(tensor)  # synchronous: the slot reads it next
                tensor = self._staging
            host = tensor.contiguous().numpy()
            if self._is_bf16:
                host = host.view(np.uint16)
        elif self._is_bf16:
            raise ValueError(f"channel carries bfloat16, got {type(tensor).__name__}")
        else:
            host = np.ascontiguousarray(tensor)
        self._ch.write(host, timeout=timeout)

    def reader(self, reader_index: int = 0,
               device: Any = None) -> "DeviceTensorReader":
        return DeviceTensorReader(self.name, self.shape, self.dtype,
                                  self._ch.num_readers, reader_index,
                                  device)

    def close(self) -> None:
        self._ch.close()

    def __reduce__(self):
        return (_rebuild_channel, (self.name, self.shape, self.dtype,
                                   self._ch.num_readers))


def _rebuild_channel(name, shape, dtype, num_readers):
    ch = DeviceTensorChannel.__new__(DeviceTensorChannel)
    ch.shape = tuple(shape)
    ch.dtype = str(dtype)
    wire, ch._is_bf16 = _wire_dtype(ch.dtype)
    ch._ch = TensorChannel(shape, wire, num_readers=num_readers,
                           name=name, _attach=True)
    ch.name = name
    ch._staging = None
    return ch


class DeviceTensorReader:
    """Reads the shm slot and lands the tensor on a device.

    ``device=None`` is the card (the leased one in a worker), raising on
    the first read where there is none; ``device="cpu"`` only where the
    caller asks. The device is resolved at the first read, in the
    process that reads (a reader is made in one process and pickled into
    another)."""

    def __init__(self, name: str, shape, dtype: str, num_readers: int,
                 reader_index: int, device: Any = None):
        self.shape = tuple(shape)
        self.dtype = str(dtype)
        wire, self._is_bf16 = _wire_dtype(self.dtype)
        self._wire = _torch_dtype(wire)
        self._rd = TensorChannelReader(name, shape, wire, num_readers,
                                       reader_index)
        self.device = device
        self._staging: Optional[torch.Tensor] = None

    def read(self, timeout: Optional[float] = 10.0) -> torch.Tensor:
        """The next tensor, on the reader's device: a fresh tensor, the
        slot released as soon as it is copied out."""
        device = default_device(self.device)
        if device.type == "cpu":
            host = self._rd.read(timeout=timeout)
            out = torch.from_numpy(host.view(np.int16) if self._is_bf16 else host)
        else:
            if self._staging is None:
                self._staging = _pinned(self.shape, self._wire)
            view = self._rd.read_view(timeout=timeout)
            try:
                np.copyto(self._staging.numpy(), view.view(self._staging.numpy().dtype))
            finally:
                self._rd.release()
            out = self._staging.to(device)  # synchronous: the buffer is reused
        return out.view(torch.bfloat16) if self._is_bf16 else out

    def close(self) -> None:
        self._rd.close()

    def __reduce__(self):
        return (DeviceTensorReader, (self._rd.name, self.shape,
                                     self.dtype, self._rd.num_readers,
                                     self._rd.reader_index, self.device))
