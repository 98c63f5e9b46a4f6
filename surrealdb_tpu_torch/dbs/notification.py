"""Live-query notifications.

Role of the reference's Notification type + channel plumbing (reference:
core/src/dbs/notification.rs, core/src/doc/lives.rs): mutations on tables
with registered LIVE queries emit Notification{id, action, record, result}
into per-subscription queues, delivered only after the writing transaction
commits.
"""

from __future__ import annotations

import queue
from surrealdb_tpu_torch.utils import locks as _locks
from typing import Any, Dict, List, Optional


class Notification:
    __slots__ = ("id", "action", "record", "result")

    def __init__(self, id_: str, action: str, record, result):
        self.id = id_  # live query uuid (hex string)
        self.action = action  # CREATE | UPDATE | DELETE | KILLED
        self.record = record  # Thing
        self.result = result

    def to_value(self) -> dict:
        return {
            "id": self.id,
            "action": self.action,
            "record": self.record,
            "result": self.result,
        }

    def __repr__(self):
        return f"Notification({self.action} {self.record})"


class NotificationHub:
    """Routes notifications to per-live-query subscriber queues."""

    def __init__(self):
        self._subs: Dict[str, "queue.Queue[Notification]"] = {}
        self._lock = _locks.Lock("notification.hub")

    def subscribe(self, live_id: str) -> "queue.Queue[Notification]":
        with self._lock:
            q = self._subs.get(live_id)
            if q is None:
                q = queue.Queue()
                self._subs[live_id] = q
            return q

    def unsubscribe(self, live_id: str) -> None:
        with self._lock:
            self._subs.pop(live_id, None)

    def live_count(self) -> int:
        """Open live-query subscriptions (the node runtime gauge)."""
        with self._lock:
            return len(self._subs)

    def publish(self, n: Notification) -> None:
        with self._lock:
            q = self._subs.get(n.id)
        if q is not None:
            q.put(n)

    def drain(self, live_id: str, timeout: Optional[float] = None) -> List[Notification]:
        """Collect pending notifications for one live query (test helper)."""
        q = self.subscribe(live_id)
        out: List[Notification] = []
        try:
            if timeout:
                out.append(q.get(timeout=timeout))
            while True:
                out.append(q.get_nowait())
        except queue.Empty:
            pass
        return out
