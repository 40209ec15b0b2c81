"""Logical-axis sharding rules (PyTorch port of ray_tpu/parallel/sharding.py).

Model code names each dim of a leaf by a *logical* axis ("batch",
"embed", "expert", ...); a rule table maps logical names to mesh axes.
``spec_for`` gives the same entries as the JAX package's
``PartitionSpec``, as a tuple. Where JAX hands the spec to GSPMD, the
port cuts each rank's shard itself: ``shard_batch`` for the batch (rows and
sequence), ``local_shard`` / ``shard_tree`` for params and optimizer
moments, cut over ``fsdp``, ``tensor``, ``expert`` and ``stage``. With
``stage`` above 1 the leading ``layers`` dim of every layer-stacked leaf
is cut into contiguous stage shards (``effective_rules``, as the JAX
package's ``_effective_rules``); ``embed``, ``unembed`` and ``ln_f`` stay
whole on every stage. The model's collectives
(ray_tpu_torch/models/transformer.py) assume the placement of
``DEFAULT_RULES``; ``check_rules`` refuses other rules.
"""

from __future__ import annotations

import math
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


def check_rules(rules: Optional[Rules]) -> None:
    """Raise NotImplementedError for rules other than ``DEFAULT_RULES``:
    the sharded step's collectives are written for its placement."""
    if rules is not None and dict(rules) != DEFAULT_RULES:
        raise NotImplementedError(
            "the port's sharded step runs DEFAULT_RULES' placement only")


def effective_rules(mesh: MeshLike, rules: Optional[Rules] = None) -> Rules:
    """``rules`` (DEFAULT_RULES for None) with, when ``mesh``'s stage axis
    is above 1, the layer-stacked leaves' ``layers`` dim cut over
    ``stage``, so each stage holds only its own layers (the JAX package's
    ``_effective_rules``)."""
    rules = dict(DEFAULT_RULES if rules is None else rules)
    if mesh_sizes(mesh).get("stage", 1) > 1:
        rules.setdefault("layers", "stage")
    return rules


def axis_dim(logical_axes: Sequence[Optional[str]], mesh_axis: str,
             rules: Optional[Rules] = None) -> Optional[int]:
    """The dim of a leaf with ``logical_axes`` that the rules cut over
    ``mesh_axis`` (whatever its size), or None."""
    for dim, entry in enumerate(spec_for(logical_axes, rules)):
        if entry == mesh_axis or (isinstance(entry, tuple) and mesh_axis in entry):
            return dim
    return None


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
    logical leaf) by the spec of ``logical_axes`` under
    ``effective_rules``: a view of ``x``, or ``x`` itself when nothing is
    cut (also for ``mesh`` None). A dim that does not split evenly raises
    ValueError (``layers`` over ``stage`` among them)."""
    if mesh is None:
        return x
    for dim, entry in enumerate(spec_for(logical_axes, effective_rules(mesh, rules), mesh)):
        if entry is not None:
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
                rules: Optional[Rules] = None,
                num_microbatches: Optional[int] = None) -> Dict[str, Any]:
    """This rank's part of a global batch (a dict of tensors [B, S, ...]
    or [B]): the batch dim cut over the mesh axes the ``batch`` rule
    names ((replica, data, fsdp) by default) and the sequence dim over
    ``seq``'s (sequence), as JAX's ``batch_sharding`` places them. The
    global batch itself when ``mesh`` is None.

    With ``num_microbatches`` M (a pipelined step), the rows of each
    global microbatch (rows ``[i·B/M, (i+1)·B/M)``, as JAX's pipeline
    splits the batch) are cut over the batch axes instead, and the rank
    holds its share of microbatch 0, then of 1, ...: so its i-th M-th of
    rows, gathered over the batch axes in rank order, is global
    microbatch i (the group a MoE layer routes under the pipeline).
    ValueError if M does not divide B or the batch axes do not divide
    B/M."""
    if mesh is None:
        return batch
    out = {}
    for k, v in batch.items():
        lead = int(bool(num_microbatches) and v.ndim > 0)  # a leading microbatch dim
        if lead:
            m = num_microbatches
            if v.shape[0] % m:
                raise ValueError(f"batch {v.shape[0]} not divisible by microbatches {m}")
            v = v.reshape(m, v.shape[0] // m, *v.shape[1:])
        for dim, name in enumerate(("batch", "seq")[:v.ndim - lead]):
            entry = spec_for((name,), rules, mesh)
            if entry:
                v = _cut(v, dim + lead, mesh, entry[0])
        out[k] = v.reshape(-1, *v.shape[2:]) if lead else v
    return out


def shard_count(mesh: Optional[DeviceMesh], logical_axes: Sequence[Optional[str]],
                rules: Optional[Rules] = None) -> int:
    """The number of shards a leaf with ``logical_axes`` is cut into on
    ``mesh`` (1 for None)."""
    if mesh is None:
        return 1
    return math.prod(_shard(mesh, e)[1]
                     for e in spec_for(logical_axes, effective_rules(mesh, rules), mesh)
                     if e is not None)


def placements(spec: Sequence, mesh: DeviceMesh) -> Tuple:
    """The DTensor placements of a leaf whose ``spec_for`` entries are
    ``spec`` on ``mesh``, one a mesh dim: ``Shard(d)`` on the mesh dim
    that entry d names, ``Replicate()`` on every other. The global
    layout a local shard lies in, as a ``jax.Array`` carries it. Mesh
    axes of size 1 in an entry are dropped; an entry that still names
    two axes (one dim cut over both, which ``DEFAULT_RULES`` does to no
    param) raises NotImplementedError."""
    # imported here: torch.distributed.tensor takes about a second to
    # import, which the package's other users need not pay
    from torch.distributed.tensor import Replicate, Shard

    names, sizes = mesh.mesh_dim_names, mesh_sizes(mesh)
    out = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        axes = [a for a in ((entry,) if isinstance(entry, str) else entry or ())
                if sizes[a] > 1]
        if len(axes) > 1:
            raise NotImplementedError(
                f"dim {dim} cut over {tuple(axes)}: a checkpoint layout cuts a dim "
                f"over one mesh axis")
        if axes:
            out[names.index(axes[0])] = Shard(dim)
    return tuple(out)


__all__ = ["DEFAULT_RULES", "Rules", "spec_for", "local_shard", "shard_tree",
           "shard_batch", "shard_count", "axis_dim", "check_rules", "effective_rules",
           "placements"]
