"""Sebulba — split actor/learner fleets with zero-copy trajectory
streaming (PyTorch port of ray_tpu/rllib/podracer/sebulba.py; reference:
Podracer architectures, arXiv 2104.06272 §3).

Where each part runs: the pod actors run the numpy policy on the host,
in worker processes with no card, as the JAX package's do. Each learner
runs the port's ``IMPALALearner`` on a card of its own:
``SebulbaConfig.build()`` (``device=None``) reserves one
``{"CPU": 1, "GPU": 1}`` bundle a learner through
``util.gpu.SlicePlacementGroup`` and places the learner in it with
``num_gpus=1``; a learner asked for the card that finds none raises, it
never carries on on the CPU. ``build(device="cpu")`` keeps every learner
on the CPU and leases nothing; any other ``device`` raises ValueError. A
fragment reaches the learner as numpy from the channel and goes onto its
device with one host-to-device copy (``rollout.to_device``). ``slice_topology`` names a TPU slice, which has
no counterpart here: setting it raises ValueError.

Data plane: each actor owns TWO `experimental.TensorChannel` slots
(double buffering — fragment k+1 is written while the learner still
holds k) carrying fixed-shape packed fragments (podracer.codec). The
channels' ack protocol IS the credit system: an un-acked slot is an
outstanding credit, so a slow learner exerts backpressure by simply
not reading — the actor's write blocks and nothing is ever dropped or
duplicated (seqlock + per-reader acks). A fragment that cannot ride
the tensor path (shape mismatch against the slot spec) falls back to
the object path inside the pump reply.

Control plane: actors are `SampleRunner`-derived remote actors driven
by short `pump(n)` calls (keeping their mailbox responsive for drain
notices); learners are remote actors pulling from their assigned
streams, syncing behavior weights back through a per-actor weights
channel, checkpointing through train.checkpoint, and — with
num_learners > 1 — averaging/broadcasting params over the collective
v2 object-store backend at train-call boundaries. Learners can ride a
`SlicePlacementGroup` via ``slice_topology``.

Elasticity (podracer.fleet): a draining/preempted actor's stream ends
(EOS marker when graceful, silence + detach when not); the learner
keeps stepping on the remaining streams. A lost learner is respawned
and restores from its last checkpoint.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch import default_device
from ray_tpu_torch.experimental.channel import ChannelTimeoutError, TensorChannel
from ray_tpu_torch.rllib.algorithm import AlgorithmConfigBase
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.impala import IMPALALearner
from ray_tpu_torch.rllib.podracer.codec import (
    KIND_EOS,
    FragmentSpec,
    flat_param_size,
    pack_params,
    unpack_params,
)
from ray_tpu_torch.rllib.podracer.fleet import FleetManager
from ray_tpu_torch.rllib.podracer.obs import (
    STAGE_DEQUEUE,
    STAGE_ENQUEUE,
    STAGE_ENV_STEP,
    STAGE_UPDATE,
    STAGE_WEIGHT_SYNC,
    StageTimes,
)
from ray_tpu_torch.rllib.rollout import SampleRunner, worker_seed


@dataclasses.dataclass
class SebulbaConfig(AlgorithmConfigBase):
    env: Any = "CartPole-v1"
    num_actors: int = 2
    num_learners: int = 1
    rollout_fragment_length: int = 64
    lr: float = 5e-4
    gamma: float = 0.99
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    rho_bar: float = 1.0
    c_bar: float = 1.0
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0
    # pipeline knobs
    pump_fragments: int = 2        # fragments per actor pump() call
    updates_per_train: int = 8     # learner updates per train() call
    weight_sync_interval: int = 2  # updates between weight pushes
    sync_every_iterations: int = 1  # cross-learner sync cadence (train calls)
    checkpoint_interval: int = 25  # updates between checkpoints
    checkpoint_dir: str = ""       # auto tempdir when empty
    enqueue_timeout_s: float = 30.0  # actor-side credit wait bound
    dequeue_timeout_s: float = 0.005  # learner-side per-slot poll bound
    weight_read_timeout_s: float = 0.001  # actor-side weight poll bound
    actor_resources: Optional[Dict[str, float]] = None  # per-actor pin
    slice_topology: str = ""       # a TPU slice: raises (see module doc)


# =====================================================================
# Actor side
# =====================================================================
class _PodActorImpl(SampleRunner._cls):
    """`SampleRunner` subclass that streams fixed-shape fragments into
    its two channel slots instead of returning them by value."""

    def __init__(self, env_spec, hidden, seed, actor_index: int,
                 frag_spec: Dict[str, int],
                 enqueue_timeout_s: float = 30.0,
                 weight_read_timeout_s: float = 0.001):
        super().__init__(env_spec, hidden, seed, mode="categorical",
                         net_key="pi")
        self.hidden = tuple(hidden)
        self.actor_index = actor_index
        self.spec = FragmentSpec(**frag_spec)
        self.enqueue_timeout_s = enqueue_timeout_s
        self.weight_read_timeout_s = weight_read_timeout_s
        self._slots: Optional[List[TensorChannel]] = None
        self._weights_rx = None
        self._params_np: Optional[Dict] = None
        self.weights_version = -1
        self._frag_index = 0
        self._eos_sent = False
        self._stages = StageTimes()

    def node_id(self) -> str:
        return os.environ.get("RAY_TPU_NODE_ID", "")

    def attach_stream(self, slots, weights_reader) -> bool:
        """Wire the transport endpoints (channels pickle by shm name)."""
        self._slots = list(slots)
        self._weights_rx = weights_reader
        return True

    def _poll_weights(self, timeout: float) -> None:
        try:
            with self._stages.track(STAGE_WEIGHT_SYNC):
                vec = self._weights_rx.read(timeout=timeout)
        except ChannelTimeoutError:
            return  # no fresh weights — keep acting with the stale ones
        version, net = unpack_params(
            vec, self.env.observation_dim, self.hidden,
            self.env.num_actions)
        self.weights_version = version
        self._params_np = {"pi": net}

    def pump(self, num_fragments: int) -> Dict[str, Any]:
        """Collect and stream `num_fragments` fragments. Returns a small
        control-plane dict (metrics + any object-path fallbacks); the
        trajectory payloads travel through shared memory."""
        if self._slots is None:
            raise RuntimeError("attach_stream was never called")
        returns: List[float] = []
        fallback: List[np.ndarray] = []
        stalled = False
        streamed = 0
        # first pump blocks until the learner published initial weights
        waited = 0.0
        while self._params_np is None:
            self._poll_weights(timeout=0.5)
            waited += 0.5
            if self._params_np is None and waited >= 30.0:
                raise RuntimeError(
                    "no initial weights within 30s — learner never "
                    "attached its end of the stream")
        for _ in range(num_fragments):
            if self._eos_sent:
                break
            self._poll_weights(timeout=self.weight_read_timeout_s)
            with self._stages.track(STAGE_ENV_STEP):
                frag = self.sample(self._params_np,
                                   self.spec.num_steps)
            returns.extend(frag["episode_returns"].tolist())
            try:
                vec = self.spec.pack(frag, self._frag_index)
            except ValueError:
                # shape drifted from the slot contract — object path
                fallback.append(
                    {"frag_index": self._frag_index, "frag": frag})
                self._frag_index += 1
                continue
            slot = self._slots[self._frag_index % 2]
            try:
                with self._stages.track(STAGE_ENQUEUE):
                    slot.write(vec, timeout=self.enqueue_timeout_s)
            except ChannelTimeoutError:
                # credit never came back (learner gone/stalled) — stop
                # pumping; the driver decides what happens to this actor
                stalled = True
                break
            self._frag_index += 1
            streamed += 1
        return {
            "actor_index": self.actor_index,
            "fragments": streamed,
            "frames": streamed * self.spec.num_steps,
            "next_frag_index": self._frag_index,
            "episode_returns": returns,
            "fallback": fallback,
            "stalled": stalled,
            "weights_version": self.weights_version,
            "stage_s": self._stages.snapshot(),
        }

    def end_stream(self) -> int:
        """Write the EOS marker — the graceful credit hand-back when
        this actor's node is draining. Returns the final frag index."""
        if self._eos_sent or self._slots is None:
            return self._frag_index
        slot = self._slots[self._frag_index % 2]
        try:
            slot.write(self.spec.pack_eos(self._frag_index), timeout=2.0)
            self._eos_sent = True
        except Exception:  # noqa: BLE001
            pass  # hard preemption path: the learner detaches instead
        return self._frag_index


PodActor = ray_tpu_torch.remote(max_restarts=0)(_PodActorImpl)


# =====================================================================
# Learner side
# =====================================================================
class _Stream:
    """Learner-side view of one actor's double-buffered slot pair.
    A tiny reorder buffer keyed by fragment index absorbs slot-order
    ambiguity after a learner restart (readers resume from the acks
    persisted in the shm header, but the next-slot parity is only
    recoverable from the payload indices)."""

    def __init__(self, actor_index: int, readers, weights_ch):
        self.actor_index = actor_index
        self.readers = readers          # [TensorChannelReader, ...] x2
        self.weights = weights_ch       # TensorChannel writer endpoint
        self.expected: Optional[int] = None
        self.buf: Dict[int, Any] = {}
        self.live = True
        self.eos = False
        self.order_errors = 0
        self.consumed = 0

    def close(self) -> None:
        self.live = False
        for r in self.readers:
            try:
                r.close()
            except Exception:  # noqa: BLE001
                pass
        try:
            self.weights.close()
        except Exception:  # noqa: BLE001
            pass


class _PodLearnerImpl:
    """Batched learner pulling packed fragments from its streams.
    Wraps the existing `IMPALALearner` (same loss, same optimizer) —
    Sebulba changes the transport, not the math."""

    def __init__(self, cfg_dict: Dict[str, Any], obs_dim: int,
                 num_actions: int, rank: int = 0, world: int = 1,
                 group_name: str = "", checkpoint_dir: str = "",
                 device=None):
        cfg_dict = dict(cfg_dict)
        cfg_dict["hidden"] = tuple(cfg_dict["hidden"])
        # every learner rank starts from the SAME cfg.seed params —
        # collective averaging only makes sense from a common init
        self.cfg = SebulbaConfig(**cfg_dict)
        self.rank = rank
        self.world = world
        self.group_name = group_name or f"sebulba-{uuid.uuid4().hex[:8]}"
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        # device=None: the card this process leased; raises without one
        self.device = default_device(device)
        self.inner = IMPALALearner(self.cfg, obs_dim, num_actions,
                                   device=self.device)
        self.spec = FragmentSpec(self.cfg.rollout_fragment_length, obs_dim)
        self.updates = 0
        self.frames = 0
        self.weights_version = 0
        self.checkpoint_dir = checkpoint_dir
        self._streams: List[_Stream] = []
        self._fallback: List[Tuple[int, int, Dict]] = []
        self._stages = StageTimes()
        self._episode_returns: List[float] = []
        self._last_metrics: Dict[str, float] = {}
        if checkpoint_dir and os.path.isdir(checkpoint_dir) \
                and os.listdir(checkpoint_dir):
            self._restore()
        if world > 1:
            from ray_tpu_torch.util import collective as col

            col.init_collective_group(world, rank, backend="objstore",
                                      group_name=self.group_name)

    # -- checkpointing --------------------------------------------------
    def _ckpt_target(self):
        return dict(self.inner.state(),
                    updates=torch.zeros((), dtype=torch.int64))

    def _save(self) -> None:
        from ray_tpu_torch.train.checkpoint import save_state

        save_state(dict(self.inner.state(),
                        updates=torch.tensor(self.updates, dtype=torch.int64)),
                   self.checkpoint_dir)

    def _restore(self) -> None:
        """Params, Adam state (the port's layout) and ``updates`` onto
        this learner's own device."""
        from ray_tpu_torch.train.checkpoint import restore_state

        state = restore_state(self.checkpoint_dir,
                              target=self._ckpt_target(), device=self.device)
        self.updates = int(state.pop("updates"))
        self.inner.load_state(state)

    def save_checkpoint(self) -> int:
        if self.checkpoint_dir:
            self._save()
        return self.updates

    # -- stream management ---------------------------------------------
    def attach_streams(self, streams: List[Dict[str, Any]]) -> int:
        """streams: [{actor_index, readers: [r0, r1], weights: ch}].
        Pushes the current weights immediately so actors can start."""
        for s in streams:
            self._streams.append(
                _Stream(s["actor_index"], s["readers"], s["weights"]))
        self._push_weights(force=True)
        return len(self._streams)

    def detach_stream(self, actor_index: int) -> bool:
        """Hard credit hand-back for an actor that died without EOS."""
        for st in self._streams:
            if st.actor_index == actor_index and st.live:
                st.close()
                return True
        return False

    def ingest_fallback(self, actor_index: int, frags: List[Dict]) -> int:
        """Object-path fragments (shape-mismatch fallback) routed by the
        driver; consumed in order alongside the channel data."""
        for f in frags:
            self._fallback.append(
                (actor_index, f["frag_index"], f["frag"]))
        return len(self._fallback)

    def live_streams(self) -> List[int]:
        return [st.actor_index for st in self._streams if st.live]

    # -- weights --------------------------------------------------------
    def _push_weights(self, force: bool = False) -> None:
        vec = pack_params(self.inner.get_policy_np()["pi"], self.obs_dim,
                          self.cfg.hidden, self.num_actions,
                          version=self.weights_version + 1)
        pushed = False
        with self._stages.track(STAGE_WEIGHT_SYNC):
            for st in self._streams:
                if not st.live:
                    continue
                try:
                    # short bound: an actor that has not consumed the
                    # previous weights (busy, draining, dead) is skipped
                    # — staleness is V-trace's job, not backpressure's
                    st.weights.write(vec, timeout=1.0 if force else 0.05)
                    pushed = True
                except (ChannelTimeoutError, ValueError):
                    continue
        if pushed:
            self.weights_version += 1

    # -- collective sync (multi-learner) --------------------------------
    def reset_group(self, group_name: str) -> bool:
        """Rotate onto a fresh collective group (driver-directed, after a
        learner death surfaced as :class:`CollectiveRankFailure`). The
        old group's rendezvous actor may still hold state pinned to the
        dead rank; a new group name gives every survivor — and the
        respawned learner — a clean epoch-0 membership."""
        if self.world <= 1:
            self.group_name = group_name
            return True
        from ray_tpu_torch.util import collective as col

        try:
            col.destroy_collective_group(self.group_name)
        except Exception:  # noqa: BLE001 — old group is being abandoned
            pass
        self.group_name = group_name
        col.init_collective_group(self.world, self.rank,
                                  backend="objstore",
                                  group_name=group_name)
        return True

    def sync_params(self) -> int:
        """Cross-learner weight sync over the collective v2 broadcast
        path (objstore backend): rank 0's params fan out to every rank.
        Every rank must call this concurrently — the driver triggers it
        on all learners at train-call boundaries, never mid-pull (a
        collective op must be entered by the whole group in matched
        order)."""
        if self.world <= 1:
            return self.updates
        from ray_tpu_torch.util import collective as col

        leaves = flat_leaves(self.inner.params)
        flat = np.array(  # a writable copy: torch.from_numpy views it
            col.broadcast(flat_params(self.inner.params), src_rank=0,
                          group_name=self.group_name), np.float32)
        o = 0
        with torch.no_grad():
            for leaf in leaves:
                n = leaf.numel()
                leaf.copy_(torch.from_numpy(flat[o:o + n]).view(leaf.shape))
                o += n
        self._push_weights(force=False)
        return self.updates

    # -- the pull loop --------------------------------------------------
    def _poll_stream(self, st: _Stream) -> None:
        """Drain whatever is ready in either slot into the reorder
        buffer (each slot holds at most one unconsumed fragment)."""
        for rd in st.readers:
            if len(st.buf) >= 2:
                return
            try:
                with self._stages.track(STAGE_DEQUEUE):
                    vec = rd.read(timeout=self.cfg.dequeue_timeout_s)
            except ChannelTimeoutError:
                continue
            kind, idx, frag = self.spec.unpack(vec)
            st.buf[idx] = (kind, frag)

    def _next_in_order(self, st: _Stream):
        if not st.buf:
            return None
        idx = st.expected if st.expected is not None else min(st.buf)
        if idx not in st.buf:
            if min(st.buf) < idx:
                # an index below the watermark is a duplicate — count it
                # loudly and drop (the seqlock makes this unreachable;
                # the counter is the proof the tests pin to zero)
                st.order_errors += 1
                st.buf.pop(min(st.buf))
            return None
        kind, frag = st.buf.pop(idx)
        st.expected = idx + 1
        return kind, idx, frag

    def train_steps(self, max_updates: int,
                    idle_timeout_s: float = 15.0) -> Dict[str, Any]:
        """Consume fragments until `max_updates` updates ran or every
        stream ended/went idle. Never raises on stream silence — a
        shrinking fleet is a membership event, not an error."""
        target = self.updates + max_updates
        idle_deadline = time.monotonic() + idle_timeout_s
        while self.updates < target:
            progressed = False
            # object-path fallbacks first (they are already in memory)
            if self._fallback:
                self._fallback.sort(key=lambda t: t[1])
                _, _, frag = self._fallback.pop(0)
                self._update(frag)
                progressed = True
            for st in self._streams:
                if self.updates >= target:
                    break
                if not st.live:
                    continue
                self._poll_stream(st)
                if st.expected is None and st.buf:
                    # the stream's first read: a fragment older than it
                    # was published before it, in the other slot, maybe
                    # after that slot's poll; poll again before adopting
                    # the lowest index (the JAX package's learner adopts
                    # it at once and can count an order error here)
                    self._poll_stream(st)
                nxt = self._next_in_order(st)
                if nxt is None:
                    continue
                kind, idx, frag = nxt
                if kind == KIND_EOS:
                    st.eos = True
                    st.close()  # credits handed back
                    continue
                st.consumed += 1
                self._update(frag)
                progressed = True
            if progressed:
                idle_deadline = time.monotonic() + idle_timeout_s
            else:
                if not any(st.live for st in self._streams):
                    break
                if time.monotonic() > idle_deadline:
                    break
        return self.stats()

    def _update(self, frag: Dict[str, np.ndarray]) -> None:
        with self._stages.track(STAGE_UPDATE):
            metrics = self.inner.update(frag)
        self.updates += 1
        self.frames += len(frag["obs"])
        self._last_metrics = metrics
        if "episode_returns" in frag:
            self._episode_returns.extend(
                np.asarray(frag["episode_returns"]).tolist())
        if self.updates % self.cfg.weight_sync_interval == 0:
            self._push_weights()
        if self.checkpoint_dir and \
                self.updates % self.cfg.checkpoint_interval == 0:
            self._save()

    def record_returns(self, returns: List[float]) -> None:
        self._episode_returns.extend(returns)
        self._episode_returns = self._episode_returns[-200:]

    def stats(self) -> Dict[str, Any]:
        return {
            "rank": self.rank,
            "updates": self.updates,
            "frames": self.frames,
            "weights_version": self.weights_version,
            "order_errors": sum(st.order_errors for st in self._streams),
            "consumed": {st.actor_index: st.consumed
                         for st in self._streams},
            "live_streams": self.live_streams(),
            "episode_return_mean": float(np.mean(
                self._episode_returns[-100:]))
            if self._episode_returns else 0.0,
            "stage_s": self._stages.snapshot(),
            **{k: float(v) for k, v in self._last_metrics.items()},
        }

    def get_params_np(self) -> Dict:
        return self.inner.get_weights_np()


PodLearner = ray_tpu_torch.remote(max_restarts=0)(_PodLearnerImpl)


def flat_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a dict tree in ``jax.tree.flatten``'s order: keys
    sorted at every level (the port's own trees keep insertion order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flat_leaves(tree[k])]
    return [tree]


def flat_params(params) -> np.ndarray:
    """The learner's params as one fp32 host vector, laid out element for
    element as the JAX package's ``sync_params`` lays out its own."""
    return np.concatenate([leaf.detach().cpu().numpy().astype(np.float32).ravel()
                           for leaf in flat_leaves(params)])


# =====================================================================
# Driver
# =====================================================================
class Sebulba:
    """Driver: owns the channels, the actor fleet, and the learner(s);
    `train()` runs one pull-iteration per learner while keeping actor
    pumps in flight and absorbing membership churn (see module doc)."""

    def __init__(self, cfg: SebulbaConfig, device=None):
        if cfg.slice_topology:
            raise ValueError(
                f"slice_topology={cfg.slice_topology!r} names a TPU slice; "
                "each learner leases one card of its own (device=None)")
        probe = make_env(cfg.env)
        self.cfg = cfg
        self.obs_dim = probe.observation_dim
        self.num_actions = probe.num_actions
        self.spec = FragmentSpec(cfg.rollout_fragment_length, self.obs_dim)
        self.checkpoint_dir = cfg.checkpoint_dir or tempfile.mkdtemp(
            prefix="sebulba-ckpt-")
        self._uid = uuid.uuid4().hex[:8]
        self.fleet = FleetManager()
        self.iteration = 0
        self.app_errors = 0
        self.learner_restarts = 0
        self.group_rotations = 0
        self._group_gen = 0
        self._group_name = f"sebulba-{self._uid}-g0"
        # None: each learner on a card it leases; "cpu": no lease
        if device is not None and str(device) != "cpu":
            raise ValueError(
                f"device={device!r}: Sebulba takes None (each learner leases a "
                "card of its own) or 'cpu'")
        self.device = None if device is None else "cpu"
        self._slice_pgs: List[Any] = []
        self._pgs: List[Any] = []
        if self.device is None:
            self._lease_cards()
        self._channels: List[TensorChannel] = []  # all owned endpoints
        self._streams_by_learner: List[List[Dict[str, Any]]] = [
            [] for _ in range(cfg.num_learners)]
        self.learners: List[Any] = [None] * cfg.num_learners
        for i in range(cfg.num_actors):
            self._spawn_actor(i)
        for r in range(cfg.num_learners):
            self._spawn_learner(r, restore=False)
        self._pump_futs: Dict[Any, int] = {}  # future -> actor index
        self._eos_futs: Dict[Any, int] = {}   # end_stream future -> index

    # -- spawning -------------------------------------------------------
    def _actor_channels(self, index: int):
        flat = self.spec.flat_size
        slots = [
            TensorChannel((flat,), "float32", num_readers=1,
                          name=f"sbl{self._uid}d{index}s{k}")
            for k in (0, 1)
        ]
        weights = TensorChannel(
            (1 + flat_param_size(self.obs_dim, self.cfg.hidden,
                                 self.num_actions),),
            "float32", num_readers=1,
            name=f"sbl{self._uid}w{index}")
        self._channels.extend(slots + [weights])
        return slots, weights

    def _spawn_actor(self, index: int) -> None:
        cfg = self.cfg
        slots, weights = self._actor_channels(index)
        opts: Dict[str, Any] = {}
        if cfg.actor_resources:
            # per-actor resource pin, e.g. {"pod": 1} to spread actors
            # over dedicated worker nodes
            opts["resources"] = dict(cfg.actor_resources)
        ctor = PodActor.options(**opts) if opts else PodActor
        handle = ctor.remote(
            cfg.env, cfg.hidden, worker_seed(cfg.seed, index), index,
            self.spec.to_dict(),
            enqueue_timeout_s=cfg.enqueue_timeout_s,
            weight_read_timeout_s=cfg.weight_read_timeout_s)
        node_id = ""
        try:
            ray_tpu_torch.get(handle.attach_stream.remote(
                slots, weights.reader(0)), timeout=60)
            node_id = ray_tpu_torch.get(handle.node_id.remote(), timeout=60)
        except Exception:  # noqa: BLE001
            self.app_errors += 1
        self.fleet.add_actor(index, handle, node_id)
        learner_rank = index % self.cfg.num_learners
        self._streams_by_learner[learner_rank].append({
            "actor_index": index,
            "readers": [s.reader(0) for s in slots],
            "weights": weights,
        })

    def _lease_cards(self) -> None:
        """One ``{"CPU": 1, "GPU": 1}`` bundle a learner, each its own
        SlicePlacementGroup, ready before any learner spawns; a cluster
        with fewer cards than learners raises instead of waiting."""
        from ray_tpu_torch.util.gpu import SlicePlacementGroup

        have = ray_tpu_torch.cluster_resources().get("GPU", 0)
        if have < self.cfg.num_learners:
            raise RuntimeError(
                f"Sebulba's {self.cfg.num_learners} learner(s) each lease a "
                f"card and the cluster has {have:g}; pass device='cpu' to "
                "train on the CPU")
        for r in range(self.cfg.num_learners):
            spg = SlicePlacementGroup(gpus_per_host=1,
                                      name=f"sebulba-{self._uid}-l{r}")
            self._slice_pgs.append(spg)
            if not spg.ready(timeout=60):
                for held in self._slice_pgs:
                    held.remove()
                raise RuntimeError(f"learner {r}'s card lease not ready in 60 s")
            self._pgs.append(spg.placement_group)

    def _learner_options(self, rank: int) -> Dict[str, Any]:
        opts: Dict[str, Any] = {}
        if self._pgs:
            from ray_tpu_torch.util.scheduling_strategies import (
                PlacementGroupSchedulingStrategy,
            )

            opts["num_cpus"] = 1
            opts["num_gpus"] = 1
            opts["scheduling_strategy"] = PlacementGroupSchedulingStrategy(
                self._pgs[rank % len(self._pgs)],
                placement_group_bundle_index=0)
        return opts

    def _spawn_learner(self, rank: int, restore: bool) -> None:
        cfg_dict = dataclasses.asdict(self.cfg)
        opts = self._learner_options(rank)
        ctor = PodLearner.options(**opts) if opts else PodLearner
        ckpt = os.path.join(self.checkpoint_dir, f"rank{rank}")
        learner = ctor.remote(
            cfg_dict, self.obs_dim, self.num_actions, rank=rank,
            world=self.cfg.num_learners, group_name=self._group_name,
            checkpoint_dir=ckpt, device=self.device)
        live_streams = [
            s for s in self._streams_by_learner[rank]
            if self.fleet.is_live(s["actor_index"])
        ]
        ray_tpu_torch.get(learner.attach_streams.remote(live_streams),
                    timeout=120)
        self.learners[rank] = learner
        if restore:
            self.learner_restarts += 1

    # -- pump servicing -------------------------------------------------
    def _ensure_pumps(self) -> None:
        pumping = set(self._pump_futs.values())
        for slot in self.fleet.live_actors():
            if slot.index in pumping or slot.draining:
                continue
            fut = slot.handle.pump.remote(self.cfg.pump_fragments)
            self._pump_futs[fut] = slot.index

    def _service_pumps(self, timeout: float = 0.0) -> None:
        if not self._pump_futs:
            return
        ready, _ = ray_tpu_torch.wait(list(self._pump_futs),
                                num_returns=len(self._pump_futs),
                                timeout=timeout)
        for fut in ready:
            index = self._pump_futs.pop(fut)
            try:
                rep = ray_tpu_torch.get(fut, timeout=30)
            except Exception:  # noqa: BLE001
                # actor died mid-pump (preemption hard-kill): membership
                # event, not an app error — detach its credits
                self._on_actor_lost(index)
                continue
            rank = index % self.cfg.num_learners
            if rep.get("fallback"):
                try:
                    self.learners[rank].ingest_fallback.remote(
                        index, rep["fallback"])
                except Exception:  # noqa: BLE001
                    pass
            if rep.get("episode_returns"):
                try:
                    self.learners[rank].record_returns.remote(
                        rep["episode_returns"])
                except Exception:  # noqa: BLE001
                    pass
            if rep.get("stalled"):
                # credits never came back; leave the actor idle — the
                # next iteration's _ensure_pumps retries once the
                # learner drained the slots (or the fleet removes it)
                continue

    def _on_actor_lost(self, index: int) -> None:
        self.fleet.remove(index)
        rank = index % self.cfg.num_learners
        learner = self.learners[rank]
        if learner is not None:
            try:
                learner.detach_stream.remote(index)
            except Exception:  # noqa: BLE001
                pass

    def _poll_drains(self) -> None:
        for index in self.fleet.poll_drain_events():
            slot = self.fleet.actors.get(index)
            if slot is None:
                continue
            # graceful path: ask the actor to close its stream with an
            # EOS marker (hands back the channel credits); best-effort —
            # the node may die before the call lands
            try:
                self._eos_futs[slot.handle.end_stream.remote()] = index
            except Exception:  # noqa: BLE001
                self._on_actor_lost(index)

    def _service_eos(self) -> None:
        """Retire draining actors once their end_stream resolves. A
        draining actor gets no new pumps, so without this the fleet
        would never observe its departure (no pump future to fail)."""
        if not self._eos_futs:
            return
        ready, _ = ray_tpu_torch.wait(list(self._eos_futs),
                                num_returns=len(self._eos_futs),
                                timeout=0.0)
        for fut in ready:
            index = self._eos_futs.pop(fut)
            try:
                ray_tpu_torch.get(fut, timeout=5)
                # EOS written: membership shrinks here; the learner
                # closes its end in-band when it consumes the marker
                self.fleet.remove(index)
            except Exception:  # noqa: BLE001
                # node died before the EOS landed — hard credit
                # hand-back (detach the learner-side stream too)
                self._on_actor_lost(index)

    # -- main loop ------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        cfg = self.cfg
        self._poll_drains()
        self._service_eos()
        self._ensure_pumps()
        learner_stats: List[Optional[Dict[str, Any]]] = \
            [None] * cfg.num_learners
        futs = {}
        for r, learner in enumerate(self.learners):
            futs[learner.train_steps.remote(cfg.updates_per_train)] = r
        pending = list(futs)
        while pending:
            ready, pending = ray_tpu_torch.wait(
                pending, num_returns=1, timeout=0.25)
            self._service_pumps(timeout=0.0)
            self._poll_drains()
            self._service_eos()
            self._ensure_pumps()
            for fut in ready:
                r = futs[fut]
                try:
                    learner_stats[r] = ray_tpu_torch.get(fut, timeout=30)
                except Exception:  # noqa: BLE001
                    # learner death: respawn from last checkpoint, same
                    # streams (readers resume from the persisted acks)
                    try:
                        self._spawn_learner(r, restore=True)
                    except Exception:  # noqa: BLE001
                        self.app_errors += 1
                    learner_stats[r] = {"updates": 0, "frames": 0,
                                        "restarted": True}
        if cfg.num_learners > 1 and \
                self.iteration % max(1, cfg.sync_every_iterations) == 0:
            self._sync_learners()
        self.iteration += 1
        agg = [s for s in learner_stats if s]
        total_updates = sum(s.get("updates", 0) for s in agg)
        total_frames = sum(s.get("frames", 0) for s in agg)
        out = {
            "training_iteration": self.iteration,
            "num_updates": total_updates,
            "num_env_steps_trained": total_frames,
            "order_errors": sum(s.get("order_errors", 0) for s in agg),
            "live_actors": [s.index for s in self.fleet.live_actors()],
            "app_errors": self.app_errors,
            "learner_restarts": self.learner_restarts,
            "group_rotations": self.group_rotations,
            "episode_return_mean": float(np.mean(
                [s["episode_return_mean"] for s in agg
                 if s.get("episode_return_mean") is not None]))
            if any("episode_return_mean" in s for s in agg) else 0.0,
            "learners": agg,
        }
        return out

    # -- collective sync + group rotation -------------------------------
    def _sync_learners(self) -> None:
        """Cross-learner weight sync with elastic recovery. A learner
        lost mid-broadcast no longer stalls the driver to the full
        deadline: survivors raise :class:`CollectiveRankFailure` (or
        :class:`CollectiveTimeoutError`) within the detection window and
        the dead learner's own future fails with an actor error. Both
        are MEMBERSHIP events, not app errors — the response is to
        respawn the dead rank from its checkpoint and rotate the whole
        fleet onto a fresh collective group generation."""
        from ray_tpu_torch.exceptions import RayActorError
        from ray_tpu_torch.util.collective import CollectiveError

        sync_futs = {ln.sync_params.remote(): r
                     for r, ln in enumerate(self.learners)}
        membership_event = False
        for fut, r in sync_futs.items():
            try:
                ray_tpu_torch.get(fut, timeout=120)
            except Exception as e:  # noqa: BLE001
                if isinstance(e, (CollectiveError, RayActorError)):
                    membership_event = True
                else:
                    self.app_errors += 1
        if membership_event:
            self._rotate_group()

    def _rotate_group(self) -> None:
        """Respawn dead learners from checkpoint and move every learner
        onto a fresh group name (`-g{N}`): the old group's rendezvous
        still carries the dead rank's pins, so survivors re-init into a
        clean epoch-0 membership instead of waiting out a resize."""
        self._group_gen += 1
        self.group_rotations += 1
        self._group_name = f"sebulba-{self._uid}-g{self._group_gen}"
        survivors: List[int] = []
        dead: List[int] = []
        for r, learner in enumerate(self.learners):
            try:
                ray_tpu_torch.get(learner.live_streams.remote(), timeout=10)
                survivors.append(r)
            except Exception:  # noqa: BLE001
                dead.append(r)
        # survivor resets are fired BEFORE the respawns and collected
        # after: whichever side holds rank 0 creates the new group's
        # rendezvous, and the other side's init waits for it — a
        # sequential order would deadlock one of the two cases
        reset_futs = [self.learners[r].reset_group.remote(self._group_name)
                      for r in survivors]
        for r in dead:  # respawn joins the rotated group via __init__
            try:
                self._spawn_learner(r, restore=True)
            except Exception:  # noqa: BLE001
                self.app_errors += 1
        try:
            ray_tpu_torch.get(reset_futs, timeout=120)
        except Exception:  # noqa: BLE001
            self.app_errors += 1

    # -- lifecycle ------------------------------------------------------
    def save(self) -> int:
        futs = [ln.save_checkpoint.remote() for ln in self.learners
                if ln is not None]
        return max(ray_tpu_torch.get(futs, timeout=60)) if futs else 0

    def kill_learner(self, rank: int = 0) -> None:
        """Test/chaos hook: hard-kill one learner actor."""
        try:
            ray_tpu_torch.kill(self.learners[rank])
        except Exception:  # noqa: BLE001
            pass

    def stop(self) -> None:
        for fut in list(self._pump_futs):
            try:
                ray_tpu_torch.cancel(fut)
            except Exception:  # noqa: BLE001
                pass
        self._pump_futs.clear()
        for slot in list(self.fleet.actors.values()):
            try:
                ray_tpu_torch.kill(slot.handle)
            except Exception:  # noqa: BLE001
                pass
        for learner in self.learners:
            if learner is None:
                continue
            try:
                ray_tpu_torch.kill(learner)
            except Exception:  # noqa: BLE001
                pass
        for ch in self._channels:
            try:
                ch.close()
            except Exception:  # noqa: BLE001
                pass
        self._channels.clear()
        for spg in self._slice_pgs:
            spg.remove()
        self._slice_pgs.clear()


SebulbaConfig.algo_cls = Sebulba
