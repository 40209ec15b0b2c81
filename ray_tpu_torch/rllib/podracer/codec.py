"""Fixed-shape codecs for Podracer trajectory/weight streaming (copy of
ray_tpu/rllib/podracer/codec.py).

Sebulba's data plane is `experimental.TensorChannel` — a shared-memory
slot of ONE fixed shape/dtype. Everything an IMPALA update consumes
(obs, actions, rewards, terminateds, truncs, behavior logp, bootstrap
last_obs) is therefore packed into a single flat float32 vector with a
tiny header, so a fragment transfer is exactly one memcpy into shm and
one out, no pickling (reference: the RDT host path the channels module
reproduces). Weights ride the same way: the actor policy net flattened
in a deterministic key order behind a version counter.

Float32 carries the header integers exactly (frame counts and fragment
indices stay far below 2**24).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

# header words: [kind, frag_index, num_steps, reserved]
HEADER_SIZE = 4
KIND_DATA = 0
KIND_EOS = 1  # end-of-stream marker: the writer hands its credits back


@dataclasses.dataclass(frozen=True)
class FragmentSpec:
    """Shape contract of one trajectory fragment slot."""

    num_steps: int
    obs_dim: int

    @property
    def flat_size(self) -> int:
        t, d = self.num_steps, self.obs_dim
        # obs[T,D] act[T] rew[T] term[T] trunc[T] logp[T] last_obs[D]
        return HEADER_SIZE + t * (d + 5) + d

    def to_dict(self) -> Dict[str, int]:
        return {"num_steps": self.num_steps, "obs_dim": self.obs_dim}

    # -- fragments ------------------------------------------------------
    def pack(self, frag: Dict[str, np.ndarray], frag_index: int,
             kind: int = KIND_DATA) -> np.ndarray:
        t, d = self.num_steps, self.obs_dim
        obs = np.asarray(frag["obs"], np.float32)
        if obs.shape != (t, d):
            raise ValueError(
                f"fragment obs {obs.shape} does not match spec ({t}, {d})")
        out = np.empty(self.flat_size, np.float32)
        out[0] = float(kind)
        out[1] = float(frag_index)
        out[2] = float(t)
        out[3] = 0.0
        o = HEADER_SIZE
        out[o:o + t * d] = obs.ravel()
        o += t * d
        for key in ("actions", "rewards", "terminateds", "truncs", "logp"):
            out[o:o + t] = np.asarray(frag[key], np.float32)
            o += t
        out[o:o + d] = np.asarray(frag["last_obs"], np.float32)
        return out

    def pack_eos(self, frag_index: int) -> np.ndarray:
        out = np.zeros(self.flat_size, np.float32)
        out[0] = float(KIND_EOS)
        out[1] = float(frag_index)
        return out

    def unpack(self, vec: np.ndarray) -> Tuple[int, int, Dict[str, np.ndarray]]:
        """(kind, frag_index, fragment) — fragment is None for EOS."""
        kind = int(round(float(vec[0])))
        frag_index = int(round(float(vec[1])))
        if kind == KIND_EOS:
            return kind, frag_index, None
        t, d = self.num_steps, self.obs_dim
        o = HEADER_SIZE
        obs = vec[o:o + t * d].reshape(t, d).copy()
        o += t * d
        fields = {}
        for key in ("actions", "rewards", "terminateds", "truncs", "logp"):
            fields[key] = vec[o:o + t].copy()
            o += t
        last_obs = vec[o:o + d].copy()
        return kind, frag_index, {
            "obs": obs,
            "actions": np.round(fields["actions"]).astype(np.int32),
            "rewards": fields["rewards"],
            "terminateds": fields["terminateds"] > 0.5,
            "truncs": fields["truncs"] > 0.5,
            "logp": fields["logp"],
            "last_obs": last_obs,
        }


# -- policy weights -----------------------------------------------------
def _layer_shapes(obs_dim: int, hidden: Tuple[int, ...], out_dim: int):
    """(key, shape) pairs in the canonical flattening order — the same
    layer names `rollout.init_mlp_params` produces."""
    sizes = (obs_dim,) + tuple(hidden)
    shapes = []
    for i in range(len(sizes) - 1):
        shapes.append((f"w{i}", (sizes[i], sizes[i + 1])))
        shapes.append((f"b{i}", (sizes[i + 1],)))
    shapes.append(("head_w", (sizes[-1], out_dim)))
    shapes.append(("head_b", (out_dim,)))
    return shapes


def flat_param_size(obs_dim: int, hidden: Tuple[int, ...],
                    out_dim: int) -> int:
    return sum(int(np.prod(s)) for _, s in
               _layer_shapes(obs_dim, hidden, out_dim))


def pack_params(net: Dict[str, np.ndarray], obs_dim: int,
                hidden: Tuple[int, ...], out_dim: int,
                version: int = 0) -> np.ndarray:
    """[version][flattened layers] — one float32 vector per weight sync."""
    out = np.empty(1 + flat_param_size(obs_dim, hidden, out_dim),
                   np.float32)
    out[0] = float(version)
    o = 1
    for key, shape in _layer_shapes(obs_dim, hidden, out_dim):
        arr = np.asarray(net[key], np.float32)
        if arr.shape != shape:
            raise ValueError(f"param {key}: {arr.shape} != {shape}")
        n = arr.size
        out[o:o + n] = arr.ravel()
        o += n
    return out


def unpack_params(vec: np.ndarray, obs_dim: int, hidden: Tuple[int, ...],
                  out_dim: int) -> Tuple[int, Dict[str, np.ndarray]]:
    version = int(round(float(vec[0])))
    net = {}
    o = 1
    for key, shape in _layer_shapes(obs_dim, hidden, out_dim):
        n = int(np.prod(shape))
        net[key] = vec[o:o + n].reshape(shape).copy()
        o += n
    return version, net
