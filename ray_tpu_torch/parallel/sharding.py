"""Logical-axis sharding rules (PyTorch port of ray_tpu/parallel/sharding.py).

Model code names each dim of a leaf by a *logical* axis ("batch",
"embed", "expert", ...); a rule table maps logical names to mesh axes.
``spec_for`` gives the same entries as the JAX package's
``PartitionSpec``, as a tuple. Where JAX hands the spec to GSPMD, the
port cuts each rank's shard itself: ``shard_batch`` for the batch,
``local_shard`` / ``shard_tree`` for params and optimizer moments.

This slice shards the batch over (replica, data, fsdp) and leaves over
``expert``; a leaf's spec that names any other mesh axis above 1 raises
(FSDP and TP: ROADMAP.md Queue A item 3).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.parallel.mesh import MeshLike, mesh_sizes

# One rule entry: logical axis name → mesh axis, tuple of mesh axes, or None.
Rules = Dict[str, Union[str, Tuple[str, ...], None]]

# Default rule table for transformer LMs. Batch is split over every
# data-like axis; parameters shard over (fsdp, tensor); sequence over the
# sequence axis (ring attention); experts over expert.
DEFAULT_RULES: Rules = {
    "batch": ("replica", "data", "fsdp"),
    "seq": "sequence",
    "embed": "fsdp",
    "heads": "tensor",
    "kv_heads": "tensor",
    "head_dim": None,
    "mlp": "tensor",
    "vocab": "tensor",
    "expert": "expert",
    "stage": "stage",
    "norm": None,
    "lora_rank": None,
}

# mesh axes a leaf's dim may be cut over in this slice
_LEAF_AXES = ("expert",)
_LEAF_TODO = "ROADMAP.md Queue A item 3 (FSDP and tensor parallelism)"


def spec_for(logical_axes: Sequence[Optional[str]], rules: Optional[Rules] = None,
             mesh: MeshLike = None) -> Tuple:
    """Map a tuple of logical axis names (one per array dim, None =
    replicated) to the entries of JAX's PartitionSpec, as a tuple: per
    dim None, a mesh axis name or a tuple of them; trailing Nones
    trimmed. If ``mesh`` (a DeviceMesh, MeshSpec or sizes mapping) is
    given, mesh axes of size 1 are dropped."""
    rules = DEFAULT_RULES if rules is None else rules
    sizes = None if mesh is None else mesh_sizes(mesh)
    out = []
    for name in logical_axes:
        target = None if name is None else rules.get(name)
        if target is None:
            out.append(None)
            continue
        if isinstance(target, str):
            target = (target,)
        if sizes is not None:
            target = tuple(a for a in target if sizes.get(a, 1) > 1)
        if not target:
            out.append(None)
        elif len(target) == 1:
            out.append(target[0])
        else:
            out.append(tuple(target))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _shard(mesh: DeviceMesh, entry) -> Tuple[int, int]:
    """(index, count): this rank's shard of a dim cut over ``entry`` (a
    mesh axis or a tuple of them, outer first, as JAX orders a
    PartitionSpec entry) and the number of shards."""
    axes = (entry,) if isinstance(entry, str) else entry
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for a in axes:
        n = mesh.size(names.index(a))
        index, count = index * n + coord[names.index(a)], count * n
    return index, count


def _cut(x, dim: int, mesh: DeviceMesh, entry):
    index, count = _shard(mesh, entry)
    size = x.shape[dim]
    if size % count:
        raise ValueError(f"dim {dim} of size {size} does not split {count} ways over {entry}")
    part = size // count
    return x[(slice(None),) * dim + (slice(index * part, (index + 1) * part),)]


def local_shard(mesh: Optional[DeviceMesh], x, logical_axes: Sequence[Optional[str]],
                rules: Optional[Rules] = None):
    """This rank's shard of ``x`` (a tensor or numpy array, the whole
    logical leaf) by the spec of ``logical_axes``: a view of ``x``, or
    ``x`` itself when nothing is cut (also for ``mesh`` None)."""
    if mesh is None:
        return x
    for dim, entry in enumerate(spec_for(logical_axes, rules, mesh)):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        if any(a not in _LEAF_AXES for a in axes):
            raise NotImplementedError(
                f"a leaf cut over {entry} is not ported yet ({_LEAF_TODO})")
        x = _cut(x, dim, mesh, entry)
    return x


def shard_tree(mesh: Optional[DeviceMesh], tree: Dict[str, Any], axes: Dict[str, Any],
               rules: Optional[Rules] = None, leaf=None) -> Dict[str, Any]:
    """``tree`` (a nested dict of tensors or arrays) with each leaf cut to
    this rank's shard by the matching logical axes in ``axes`` (a
    ``param_axes``-shaped dict), then passed through ``leaf`` if given."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = shard_tree(mesh, v, axes[k], rules, leaf)
        else:
            v = local_shard(mesh, v, axes[k], rules)
            out[k] = v if leaf is None else leaf(v)
    return out


def shard_batch(mesh: Optional[DeviceMesh], batch: Dict[str, Any],
                rules: Optional[Rules] = None) -> Dict[str, Any]:
    """This rank's rows of a global batch (a dict of tensors, leading dim
    = batch): the batch dim is cut over the mesh axes the ``batch`` rule
    names ((replica, data, fsdp) by default), as JAX's ``shard_batch``
    places it. The global batch itself when ``mesh`` is None."""
    if mesh is None:
        return batch
    spec = spec_for(("batch",), rules, mesh)
    if not spec:
        return batch
    return {k: _cut(v, 0, mesh, spec[0]) if v.dim() else v for k, v in batch.items()}


def is_sharded(spec: Tuple) -> bool:
    """Whether a spec from ``spec_for`` cuts any dim."""
    return any(e is not None for e in spec)


__all__ = ["DEFAULT_RULES", "Rules", "spec_for", "local_shard", "shard_tree",
           "shard_batch", "is_sharded"]
