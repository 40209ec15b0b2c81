"""Topology model for the v2 collective stack (copy of
ray_tpu/util/collective/v2/topology.py).

A collective group's ranks live on hosts; hosts are joined by RPC (the
object path) while ranks sharing a host are joined by shared memory.
Every hierarchical algorithm in this package is phrased against this
model:

- the **local group** of a rank: all ranks on its host, ordered by
  global rank; ``local_rank`` is the rank's index in that order.
- the **leader** of a host: its lowest global rank (creates the host's
  shm arena).
- the **counterpart group** of a rank: the ranks holding the same
  local index on every host — the unit that exchanges partially
  reduced segments across hosts (one counterpart group per segment,
  so the cross-host phase is spread over every local rank instead of
  funneling through one leader).

The topology is built from ONE group-wide exchange of per-rank host
keys (folded into the existing policy agreement, zero extra round
trips), so every rank derives the identical structure.

``RAY_TPU_COLLECTIVE_TOPOLOGY_KEY`` overrides the host key — tests use
it to exercise the multi-host composition on a single box (the arenas
then span a *subset* of ranks on one real host, which shared memory is
indifferent to), and deployments can use it to model failure domains
finer than a hostname (e.g. one key per TPU slice).
"""

from __future__ import annotations

import os
import socket
from typing import Dict, List, Tuple


def node_key() -> str:
    """This process's locality-domain key (hostname unless overridden)."""
    return os.environ.get("RAY_TPU_COLLECTIVE_TOPOLOGY_KEY") \
        or socket.gethostname()


class Topology:
    """Immutable map of where every rank of a group lives."""

    def __init__(self, rank: int, keys):
        self.rank = int(rank)
        self.keys: Tuple[str, ...] = tuple(keys)
        self.world_size = len(self.keys)
        hosts: List[str] = []
        by_host: Dict[str, List[int]] = {}
        for r, k in enumerate(self.keys):
            if k not in by_host:
                hosts.append(k)
                by_host[k] = []
            by_host[k].append(r)
        self.hosts: Tuple[str, ...] = tuple(hosts)
        self._by_host = {h: tuple(rs) for h, rs in by_host.items()}
        self.n_hosts = len(self.hosts)
        self.my_host = self.keys[self.rank]
        self.local_peers: Tuple[int, ...] = self._by_host[self.my_host]
        self.local_rank = self.local_peers.index(self.rank)
        self.local_world = len(self.local_peers)

    # ------------------------------------------------------------------
    @property
    def single_host(self) -> bool:
        return self.n_hosts == 1

    @property
    def uniform(self) -> bool:
        """Every host holds the same number of ranks (precondition for
        the counterpart-group cross-host phase)."""
        return all(len(self._by_host[h]) == self.local_world
                   for h in self.hosts)

    @property
    def is_local_leader(self) -> bool:
        return self.local_rank == 0

    def local_ranks(self, host: str) -> Tuple[int, ...]:
        return self._by_host[host]

    def leader(self, host: str) -> int:
        return self._by_host[host][0]

    def counterparts(self, local_index: int | None = None) -> Tuple[int, ...]:
        """Global ranks holding ``local_index`` on each host, in host
        order. Only meaningful on uniform topologies."""
        li = self.local_rank if local_index is None else local_index
        return tuple(self._by_host[h][li] for h in self.hosts)

    def describe(self) -> dict:
        """Compact summary for events/spans."""
        return {
            "n_hosts": self.n_hosts,
            "world_size": self.world_size,
            "local_world": self.local_world,
            "uniform": self.uniform,
        }

    def __repr__(self) -> str:  # debugging aid
        return (f"Topology(rank={self.rank}, hosts={self.n_hosts}, "
                f"local={self.local_rank}/{self.local_world}, "
                f"world={self.world_size})")
