"""Elastic fleet membership for Sebulba (drain-protocol integration) (copy of
ray_tpu/rllib/podracer/fleet.py).

The fleet watches the cluster event bus for `drain_start` events
(the drain protocol: GCS DrainNode -> raylet Drain -> workers refuse new
pushes) and maps a draining node onto the pod actors living there.
A draining actor is asked to end its stream gracefully (EOS marker =
channel-credit hand-back); a hard-killed one is detected by its pump
future failing and detached learner-side. Either way the learner keeps
stepping on the surviving streams — membership is data, not an error.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from ray_tpu_torch._private.drain import EVENT_DRAIN_START


@dataclasses.dataclass
class ActorSlot:
    index: int
    handle: Any
    node_id: str
    live: bool = True
    draining: bool = False


class FleetManager:
    def __init__(self) -> None:
        self.actors: Dict[int, ActorSlot] = {}
        self.removed: List[int] = []
        self._drained_nodes: set = set()
        self._events_seen = 0

    def add_actor(self, index: int, handle: Any, node_id: str) -> None:
        self.actors[index] = ActorSlot(index, handle, node_id)

    def is_live(self, index: int) -> bool:
        slot = self.actors.get(index)
        return bool(slot and slot.live)

    def live_actors(self) -> List[ActorSlot]:
        return [s for s in self.actors.values() if s.live]

    def remove(self, index: int) -> None:
        slot = self.actors.get(index)
        if slot and slot.live:
            slot.live = False
            self.removed.append(index)

    def mark_draining(self, node_id: str) -> List[int]:
        """Flag every live actor on `node_id` as draining; returns the
        newly draining indices (each reported exactly once)."""
        out = []
        for slot in self.actors.values():
            if slot.live and not slot.draining \
                    and slot.node_id == node_id:
                slot.draining = True
                out.append(slot.index)
        return out

    def poll_drain_events(self) -> List[int]:
        """Scan the cluster event bus for new drain_start events and
        mark the affected actors. Best-effort: an unreachable GCS means
        no event this round, never an exception into the train loop."""
        from ray_tpu_torch.util import state as rstate

        try:
            events = rstate.list_events(etype=EVENT_DRAIN_START)
        except Exception:  # noqa: BLE001
            return []
        newly: List[int] = []
        for ev in events[self._events_seen:]:
            node_id = ev.get("node_id", "")
            if node_id and node_id not in self._drained_nodes:
                self._drained_nodes.add(node_id)
                newly.extend(self.mark_draining(node_id))
        self._events_seen = len(events)
        return newly
