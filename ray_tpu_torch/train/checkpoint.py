"""Checkpoints (PyTorch port of ray_tpu/train/checkpoint.py): a directory
handle with a metrics sidecar, keep-K retention, and the train state
saved and restored through ``torch.distributed.checkpoint`` (DCP), what
orbax is to the JAX package: per-shard files, and a restore onto another
mesh or onto one process.

A ``jax.Array`` carries its global shape and sharding; the port's leaves
are plain local shards. So ``save_state`` takes the layout beside the
state (``shardings=``, the ``state_shardings`` specs, and ``mesh=``) and
wraps each shard as a DTensor of its global shape
(``parallel.sharding.placements``): DCP records the global shape and
which rank wrote which chunk, and a restore reads each rank's chunks of
whatever layout it asks for. Without a mesh the leaves are whole
tensors, on one process or the same on every rank.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
import warnings
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import mesh_device
from ray_tpu_torch.parallel.sharding import placements


class Checkpoint:
    """A directory of checkpoint data (reference: train/_checkpoint.py:56)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        return self.path

    def to_directory(self, dest: Optional[str] = None) -> str:
        dest = dest or tempfile.mkdtemp(prefix="ckpt_")
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    # -- metrics sidecar -------------------------------------------------
    def update_metadata(self, metadata: Dict[str, Any]) -> None:
        """Merge ``metadata`` into the existing metadata (reference:
        train/_checkpoint.py:169 — update merges; set_metadata overwrites)."""
        merged = self.get_metadata()
        merged.update(metadata)
        self.set_metadata(merged)

    def set_metadata(self, metadata: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, ".metadata.json"), "w") as f:
            json.dump(metadata, f)

    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, ".metadata.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"


# ---------------------------------------------------------------------------
# Sharded train-state save/restore (torch.distributed.checkpoint)
# ---------------------------------------------------------------------------

def _map(fn, tree, *others):
    """``fn`` over the leaves of a tree of dicts (and the matching leaves
    of ``others``, trees of the same keys)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    return fn(tree, *others)


def _group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _barrier() -> None:
    if _group():
        dist.barrier()


def _run(call, tree, **kw) -> None:
    """``dcp.save`` or ``dcp.load`` of ``tree``, in one process when no
    process group is up (said here, not warned about). DCP and DTensor
    are imported where they are used: together they take about a second
    to import, which the package's other users need not pay."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "torch.distributed is disabled")
        call(tree, no_dist=not _group(), **kw)


def _global(t: torch.Tensor, spec, mesh):
    """The local shard ``t`` as a DTensor of its global shape on ``mesh``."""
    from torch.distributed.tensor import DTensor

    place = placements(spec, mesh)
    shape = list(t.shape)
    for i, p in enumerate(place):
        if p.is_shard():
            shape[p.dim] *= mesh.size(i)
    return DTensor.from_local(t, mesh, place, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _check_layout(shardings, mesh) -> None:
    if (shardings is None) != (mesh is None):
        raise ValueError("shardings= and mesh= go together: the specs are of that mesh")


def save_state(state: Any, directory: str, *, shardings: Any = None, mesh=None) -> None:
    """Save a train state (a tree of dicts of tensors) to ``directory``:
    written to ``directory + ".tmp"`` (a stale one removed first), then
    renamed over ``directory``. Under a process group every rank calls
    it; each writes its own shards, rank 0 the metadata, and rank 0
    renames after a barrier. ``shardings`` (``state_shardings(cfg, opt,
    mesh)``) and ``mesh`` give the layout the leaves are local shards of;
    without them every leaf is whole."""
    import torch.distributed.checkpoint as dcp

    _check_layout(shardings, mesh)
    directory = os.path.abspath(directory)
    tmp = directory + ".tmp"
    rank0 = not _group() or dist.get_rank() == 0
    if rank0:
        os.makedirs(os.path.dirname(directory) or ".", exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
    _barrier()
    tree = state if mesh is None else _map(lambda t, s: _global(t, s, mesh), state, shardings)
    _run(dcp.save, tree, storage_writer=dcp.FileSystemWriter(tmp))
    _barrier()
    if rank0:
        if os.path.exists(directory):
            shutil.rmtree(directory)
        os.replace(tmp, directory)
    _barrier()


def _saved(reader) -> Dict[tuple, Any]:
    """The saved leaves' metadata (size, properties.dtype) by key path."""
    md = reader.read_metadata()
    return {tuple(path): md.state_dict_metadata[fqn] for fqn, path in md.planner_data.items()}


def _unflatten(flat: Dict[tuple, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _abstract(target, saved, path=()):
    """(shape, dtype) leaves of ``target``: a tensor's own (a meta tensor
    among them); a ``param_shapes`` entry ``(shape, fan_in)`` takes the
    saved dtype."""
    if isinstance(target, dict):
        return {k: _abstract(v, saved, path + (k,)) for k, v in target.items()}
    if isinstance(target, torch.Tensor):
        return tuple(target.shape), target.dtype
    return tuple(target[0]), saved[path].properties.dtype


def restore_state(directory: str, target: Any = None, shardings: Any = None, *,
                  mesh=None, device=None) -> Any:
    """Restore a tree saved by ``save_state`` onto ``device`` (default: the
    mesh's device type, else the card), in any layout: ``target`` gives
    the global shapes and dtypes (tensors, meta tensors or
    ``param_shapes`` entries; a saved dtype that differs is cast to the
    target's), or with no target the saved tree is rebuilt from DCP's
    metadata. With ``shardings`` and ``mesh`` each leaf is this rank's
    shard of that layout, which need not be the one saved under (another
    mesh, another world size); without them every leaf is whole, in a
    process with no group as well (N writers, one reader)."""
    import torch.distributed.checkpoint as dcp

    _check_layout(shardings, mesh)
    device = mesh_device(mesh, device)
    reader = dcp.FileSystemReader(os.path.abspath(directory))
    saved = _saved(reader)
    abstract = (_unflatten({p: (tuple(m.size), m.properties.dtype) for p, m in saved.items()})
                if target is None else _abstract(target, saved))

    def empty(sd, spec=None):
        if mesh is None:
            return torch.empty(sd[0], dtype=sd[1], device=device)
        local = torch.empty(_local_shape(sd[0], spec, mesh), dtype=sd[1], device=device)
        return _global(local, spec, mesh)

    tree = _map(empty, abstract) if mesh is None else _map(empty, abstract, shardings)
    _run(dcp.load, tree, storage_reader=reader)
    return tree if mesh is None else _map(lambda t: t.to_local(), tree)


def _local_shape(shape, spec, mesh) -> List[int]:
    out = list(shape)
    for i, p in enumerate(placements(spec, mesh)):
        if p.is_shard():
            if out[p.dim] % mesh.size(i):
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split "
                                 f"{mesh.size(i)} ways over {mesh.mesh_dim_names[i]}")
            out[p.dim] //= mesh.size(i)
    return out


class CheckpointManager:
    """Keep-K retention over a storage dir (reference:
    v2/_internal/execution/checkpoint/checkpoint_manager.py)."""

    def __init__(self, storage_path: str, num_to_keep: Optional[int] = None):
        self.storage_path = os.path.abspath(storage_path)
        self.num_to_keep = num_to_keep
        os.makedirs(self.storage_path, exist_ok=True)
        self._history: List[Dict[str, Any]] = []
        self._load_index()

    def _index_path(self) -> str:
        return os.path.join(self.storage_path, ".ckpt_index.json")

    def _load_index(self) -> None:
        if os.path.exists(self._index_path()):
            with open(self._index_path()) as f:
                self._history = json.load(f)

    def _save_index(self) -> None:
        with open(self._index_path(), "w") as f:
            json.dump(self._history, f)

    def register(self, checkpoint: Checkpoint, metrics: Optional[Dict] = None) -> Checkpoint:
        """Move a reported checkpoint into managed storage; evict oldest
        beyond num_to_keep."""
        seq = (self._history[-1]["seq"] + 1) if self._history else 0
        dest = os.path.join(self.storage_path, f"checkpoint_{seq:06d}")
        if os.path.abspath(checkpoint.path) != dest:
            if os.path.exists(dest):
                shutil.rmtree(dest)
            shutil.move(checkpoint.path, dest)
        managed = Checkpoint(dest)
        if metrics:
            managed.update_metadata({"metrics": metrics, "time": time.time()})
        self._history.append({"seq": seq, "path": dest, "metrics": metrics or {}})
        if self.num_to_keep is not None:
            while len(self._history) > self.num_to_keep:
                old = self._history.pop(0)
                if os.path.exists(old["path"]):
                    shutil.rmtree(old["path"])
        self._save_index()
        return managed

    def latest(self) -> Optional[Checkpoint]:
        if not self._history:
            return None
        return Checkpoint(self._history[-1]["path"])

    def best(self, metric: str, mode: str = "min") -> Optional[Checkpoint]:
        scored = [h for h in self._history if metric in h["metrics"]]
        if not scored:
            return self.latest()
        pick = (min if mode == "min" else max)(scored, key=lambda h: h["metrics"][metric])
        return Checkpoint(pick["path"])
