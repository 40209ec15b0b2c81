"""The autoscaler's decisions, the port's against the JAX package's:
every case of tests/test_autoscaler.py's ``TestDecision`` and
``TestFakeProviderLoop`` through both packages' ``compute_scaling_decision``
and ``FakeNodeProvider`` (equal results, and JAX's assertions on them); a
seeded sweep of a few hundred demands (nodes with queued shapes, pending
actors, slices, booting launches, draining and idle nodes) where the port's
``(launch, terminate)`` equals JAX's exactly, resource names ``TPU`` and
``GPU`` alike; and ``Autoscaler.update`` in both packages against the same
scripted GCS replies: the same launches by type, terminations and drains.
No cluster: the GCS is a scripted client.
"""

import numpy as np
import pytest

import ray_tpu._private.rpc as jax_rpc
import ray_tpu.autoscaler as JA
import ray_tpu_torch._private.rpc as port_rpc
import ray_tpu_torch.autoscaler as PA

PACKAGES = {"jax": (JA, jax_rpc), "port": (PA, port_rpc)}


def _demand(nodes=None, pending_actors=None):
    return {"nodes": nodes or [], "pending_actors": pending_actors or []}


def _node(nid, avail, total=None, pending=None, idle_s=0.0, head=False,
          alive=True, draining=False, labels=None):
    return {
        "node_id": nid, "alive": alive, "draining": draining, "is_head": head,
        "total": total or dict(avail), "available": avail,
        "pending_shapes": pending or [], "num_leases": 0,
        "idle_s": idle_s, "labels": labels or {},
    }


def _types(A, accel="TPU"):
    return {
        "cpu4": A.NodeTypeConfig(resources={"CPU": 4.0}, max_workers=5),
        "tpu_v5e_4": A.NodeTypeConfig(
            resources={"CPU": 8.0, accel: 4.0}, max_workers=2, slice_hosts=2),
    }


# each case: (demand, types(A) -> node types, type_counts, kwargs, check)
DECISIONS = {
    "no_demand_no_launch": (
        _demand([_node("head", {"CPU": 2}, head=True)]), _types, {}, {},
        lambda launch, term: launch == {} and term == []),
    "unmet_demand_launches_smallest_fitting_type": (
        _demand([_node("head", {"CPU": 0.0}, total={"CPU": 1.0},
                       pending=[{"CPU": 2.0}])]), _types, {}, {},
        lambda launch, term: launch == {"cpu4": 1}),
    "demand_packs_onto_one_new_node": (
        _demand([_node("head", {"CPU": 0.0}, pending=[{"CPU": 1.0}] * 4)]),
        _types, {}, {}, lambda launch, term: launch == {"cpu4": 1}),
    "max_workers_bounds_launches": (
        _demand([_node("head", {"CPU": 0.0}, pending=[{"CPU": 4.0}] * 10)]),
        _types, {"cpu4": 3}, {}, lambda launch, term: launch["cpu4"] == 2),
    "tpu_shape_launches_slice": (
        _demand([_node("head", {"CPU": 1.0}, pending=[{"TPU": 4.0}])]),
        _types, {}, {}, lambda launch, term: launch == {"tpu_v5e_4": 1}),
    "min_workers_enforced": (
        _demand(), lambda A: {"cpu4": A.NodeTypeConfig(
            resources={"CPU": 4.0}, min_workers=2, max_workers=5)}, {}, {},
        lambda launch, term: launch == {"cpu4": 2}),
    "available_capacity_absorbs_demand": (
        _demand([_node("head", {"CPU": 8.0}, pending=[{"CPU": 2.0}])]),
        _types, {}, {}, lambda launch, term: launch == {}),
    "idle_termination_spares_head_and_busy": (
        _demand([_node("head", {"CPU": 4}, idle_s=999, head=True),
                 _node("w1", {"CPU": 4}, idle_s=999),
                 _node("w2", {"CPU": 2}, idle_s=1.0)]),
        _types, {}, {"idle_timeout_s": 60}, lambda launch, term: term == ["w1"]),
    "slice_terminates_whole_or_not_at_all": (
        _demand([_node("head", {"CPU": 4}, head=True),
                 _node("s1a", {"TPU": 4}, idle_s=999),
                 _node("s1b", {"TPU": 4}, idle_s=5.0),
                 _node("s2a", {"TPU": 4}, idle_s=999),
                 _node("s2b", {"TPU": 4}, idle_s=999)]),
        _types, {}, {"idle_timeout_s": 60,
                     "node_slices": {"s1a": "sl1", "s1b": "sl1",
                                     "s2a": "sl2", "s2b": "sl2"}},
        lambda launch, term: sorted(term) == ["s2a", "s2b"]),
    "min_workers_held_through_idle_termination": (
        _demand([_node("head", {"CPU": 4}, head=True),
                 _node("w1", {"CPU": 4}, idle_s=999),
                 _node("w2", {"CPU": 4}, idle_s=999)]),
        lambda A: {"cpu4": A.NodeTypeConfig(resources={"CPU": 4.0},
                                            min_workers=1, max_workers=5)},
        {"cpu4": 2}, {"idle_timeout_s": 60,
                      "node_type_map": {"w1": "cpu4", "w2": "cpu4"}},
        lambda launch, term: len(term) == 1),
    "pending_actor_counts_as_demand": (
        _demand([_node("head", {"CPU": 0.0})], pending_actors=[{"CPU": 3.0}]),
        _types, {}, {}, lambda launch, term: launch == {"cpu4": 1}),
    # the card's counterparts of the TPU cases: the decision never reads a
    # resource's name
    "gpu_shape_launches_slice": (
        _demand([_node("head", {"CPU": 1.0}, pending=[{"GPU": 4.0}])]),
        lambda A: _types(A, "GPU"), {}, {},
        lambda launch, term: launch == {"tpu_v5e_4": 1}),
    "restarting_card_actor_launches_a_card_node": (
        _demand([_node("head", {"CPU": 2.0}, head=True)],
                pending_actors=[{"CPU": 1.0, "GPU": 1.0}]),
        lambda A: {"gpu1": A.NodeTypeConfig(resources={"CPU": 1, "GPU": 1},
                                            max_workers=1)}, {}, {},
        lambda launch, term: launch == {"gpu1": 1}),
}


@pytest.mark.parametrize("case", sorted(DECISIONS))
def test_decision_matches_jax(case):
    demand, types, counts, kwargs, check = DECISIONS[case]
    jax_out = JA.compute_scaling_decision(demand, types(JA), dict(counts), **kwargs)
    port_out = PA.compute_scaling_decision(demand, types(PA), dict(counts), **kwargs)
    assert port_out == jax_out
    assert check(*port_out)


@pytest.mark.parametrize("name", ["jax", "port"])
def test_fake_provider_slice_launch_is_atomic(name):
    A, _ = PACKAGES[name]
    p = A.FakeNodeProvider()
    ids = p.create_node("tpu", {"slice_hosts": 4}, {})
    assert len(ids) == 4
    assert len(p.non_terminated_nodes()) == 4
    p.terminate_node(ids[0])
    assert len(p.non_terminated_nodes()) == 3 and p.terminated == [ids[0]]


def test_fake_provider_ids_match_jax():
    j, p = JA.FakeNodeProvider(), PA.FakeNodeProvider()
    for node_type, cfg in [("cpu4", {}), ("gpu8", {"slice_hosts": 2}), ("cpu4", {})]:
        assert p.create_node(node_type, cfg, {}) == j.create_node(node_type, cfg, {})
    assert p.launches == j.launches
    assert p.non_terminated_nodes() == j.non_terminated_nodes()


# ---------------------------------------------------------------------------
# the seeded sweep
# ---------------------------------------------------------------------------
SWEEP = 300


def _shape(rng, accel):
    shape = {"CPU": float(rng.choice([0.0, 0.5, 1.0, 2.0, 4.0, 8.0]))}
    if rng.random() < 0.5:
        shape[accel] = float(rng.choice([1.0, 2.0, 4.0, 8.0]))
    if rng.random() < 0.1:
        shape = {k: 0.0 for k in shape}  # dropped as empty
    return shape


def _random_case(seed):
    """One demand, node-type set and scaler state, from numpy's seed."""
    rng = np.random.default_rng(seed)
    accel = "GPU" if seed % 2 else "TPU"
    quiet = rng.random() < 0.4  # no demand: only idle termination can act
    types = {
        "cpu4": dict(resources={"CPU": 4.0}, min_workers=0 if quiet else int(rng.integers(0, 2)),
                     max_workers=int(rng.integers(1, 6))),
        "acc1": dict(resources={"CPU": 2.0, accel: 1.0},
                     min_workers=0, max_workers=int(rng.integers(0, 3))),
        "acc8x2": dict(resources={"CPU": 8.0, accel: 8.0}, min_workers=0,
                       max_workers=int(rng.integers(1, 3)), slice_hosts=2),
    }
    nodes, node_slices, node_type_map = [], {}, {}
    for i in range(int(rng.integers(1, 7))):
        nid = f"n{i}"
        tname = rng.choice(list(types)) if i else None
        total = dict(types[tname]["resources"]) if tname else {"CPU": 2.0}
        avail = {k: float(rng.choice([0.0, v / 2, v])) for k, v in total.items()}
        nodes.append(_node(
            nid, avail, total=total, head=i == 0,
            pending=[] if quiet else [_shape(rng, accel) for _ in range(int(rng.integers(0, 4)))],
            idle_s=float(rng.choice([0.0, 5.0, 61.0, 500.0])),
            alive=bool(rng.random() < 0.9), draining=bool(rng.random() < 0.15),
            labels={"node_type": tname} if tname else {}))
        if tname:
            node_type_map[nid] = tname
            if tname == "acc8x2":
                node_slices[nid] = f"sl{int(rng.integers(0, 2))}"
    actors = [] if quiet else [_shape(rng, accel) for _ in range(int(rng.integers(0, 4)))]
    counts = {t: int(rng.integers(0, 3)) for t in types if rng.random() < 0.7}
    booting = {t: int(rng.integers(1, 3)) for t in types if rng.random() < 0.3}
    if rng.random() < 0.1:
        booting["unknown"] = 1  # a type no longer configured
    kwargs = dict(idle_timeout_s=60.0, node_slices=node_slices,
                  node_type_map=node_type_map, booting=booting)
    return _demand(nodes, actors), types, counts, kwargs


def test_seeded_sweep_matches_jax():
    launched = terminated = 0
    for seed in range(SWEEP):
        demand, types, counts, kwargs = _random_case(seed)
        jax_out = JA.compute_scaling_decision(
            demand, {k: JA.NodeTypeConfig(**v) for k, v in types.items()},
            dict(counts), **kwargs)
        port_out = PA.compute_scaling_decision(
            demand, {k: PA.NodeTypeConfig(**v) for k, v in types.items()},
            dict(counts), **kwargs)
        assert port_out == jax_out, f"seed {seed}: {port_out} != {jax_out}"
        launched += bool(port_out[0])
        terminated += bool(port_out[1])
    # the sweep reaches both branches often
    assert launched > SWEEP // 4 and terminated > SWEEP // 20, (launched, terminated)


# ---------------------------------------------------------------------------
# Autoscaler.update against a scripted GCS
# ---------------------------------------------------------------------------
class ScriptedGcs:
    """Stands for the GCS's RpcClient: ``GetClusterDemand`` replies come
    from ``script(round, provider)``; every call is recorded."""

    script = None
    provider = None

    def __init__(self, host, port, *args):
        self.calls = []
        self.round = 0

    def call(self, method, timeout=None, **kw):
        self.calls.append((method, kw))
        if method == "GetClusterDemand":
            self.round += 1
            return type(self).script(self.round, type(self).provider)
        return {"ok": True}


class RecordingProvider:
    """A FakeNodeProvider of either package that keeps each launch's labels."""

    def __init__(self, A):
        self.inner = A.FakeNodeProvider()
        self.labels = {}

    def create_node(self, node_type, node_config, labels):
        ids = self.inner.create_node(node_type, node_config, labels)
        for nid in ids:
            self.labels[nid] = dict(labels)
        return ids

    def terminate_node(self, nid):
        self.inner.terminate_node(nid)

    def non_terminated_nodes(self):
        return self.inner.non_terminated_nodes()


def _registered(provider, idle_s, busy=()):
    """GCS nodes for every live node the provider launched."""
    return [_node(nid, {"CPU": 8.0}, idle_s=0.0 if nid in busy else idle_s,
                  labels=provider.labels[nid])
            for nid in sorted(provider.non_terminated_nodes())]


def _script(rnd, provider):
    head = _node("head", {"CPU": 0.0}, total={"CPU": 2.0}, head=True)
    live = sorted(provider.non_terminated_nodes())
    if rnd in (1, 2):  # a card actor and a two-host shape queue: launch both
        # types; on round 2 nothing has registered yet: booting credit holds
        return _demand([dict(head, pending_shapes=[{"GPU": 8.0, "CPU": 8.0}])],
                       pending_actors=[{"CPU": 1.0, "GPU": 1.0, "small": 1.0}])
    if rnd == 3:  # everything registered and busy
        return _demand([head] + _registered(provider, 0.0, busy=live))
    if rnd == 4:  # one host of the slice idle: the slice stays
        slice_hosts = [n for n in live if provider.labels[n]["node_type"] == "gpu8x2"]
        return _demand([head] + _registered(provider, 500.0, busy=slice_hosts[:1]))
    return _demand([head] + _registered(provider, 500.0))  # all idle


def _run_updates(name, monkeypatch, rounds=5):
    A, rpc = PACKAGES[name]
    provider = RecordingProvider(A)
    monkeypatch.setattr(rpc, "RpcClient", ScriptedGcs)
    monkeypatch.setattr(ScriptedGcs, "script", staticmethod(_script))
    monkeypatch.setattr(ScriptedGcs, "provider", provider)
    types = {"gpu1": A.NodeTypeConfig(resources={"CPU": 1.0, "GPU": 1.0, "small": 1.0},
                                      max_workers=2),
             "gpu8x2": A.NodeTypeConfig(resources={"CPU": 8.0, "GPU": 8.0},
                                        max_workers=1, slice_hosts=2)}
    asc = A.Autoscaler(("127.0.0.1", 1), types, provider, idle_timeout_s=60.0)
    out = []
    for _ in range(rounds):
        launch, terminate = asc.update()
        out.append((launch, sorted(terminate)))
    drains = [(kw["node_id"], kw["reason"]) for m, kw in asc.gcs.calls if m == "DrainNode"]
    flags = [kw.get("enabled") for m, kw in asc.gcs.calls if m == "SetAutoscalerEnabled"]
    return out, drains, flags, asc.num_launches, asc.num_terminations, provider


def test_autoscaler_update_matches_jax(monkeypatch):
    jax_run = _run_updates("jax", monkeypatch)
    port_run = _run_updates("port", monkeypatch)
    assert port_run[:5] == jax_run[:5]
    rounds, drains, flags, launches, terminations, provider = port_run
    assert rounds[0][0] == {"gpu1": 1, "gpu8x2": 1}
    assert rounds[1] == ({}, [])  # booting credit: no second launch
    assert rounds[3][1] == [n for n in provider.inner.terminated if n.startswith("fake-gpu1")]
    assert len(rounds[4][1]) == 2  # the slice went whole, on the round all its hosts idled
    assert launches == 2 and terminations == 3
    assert {r for _n, r in drains} == {"DRAIN_NODE_REASON_IDLE_TERMINATION"}
    assert flags[0] is True and all(flags)
    assert provider.non_terminated_nodes() == {}
