"""Thread-safe cumulative counters for the engine's per-process stats.

``Stats`` keeps a dict-shaped read API (``stats["chunks"]``,
``dict(stats)``, iteration) while funnelling every mutation through one
lock, so concurrent replays never lose an increment:

* ``stats.add(key, n=1)``  — atomic accumulate (the only mutation the
  engine itself performs);
* ``stats[key] = v``       — locked assignment (tests zeroing counters);
* ``stats.reset()``        — zero every counter atomically.

Unknown keys raise ``KeyError`` on ``add`` — a typo'd counter name is a
bug worth surfacing, not a silently growing new key.
"""
from __future__ import annotations

import threading


class Stats:
    """A fixed-key counter map whose mutations are serialized by a lock."""

    __slots__ = ("_lock", "_c")

    def __init__(self, **counters: int):
        self._lock = threading.Lock()
        self._c = dict(counters)

    # ------------------------------------------------------------ mutation
    def add(self, key: str, n: int = 1) -> None:
        """Atomically accumulate ``n`` into an existing counter."""
        with self._lock:
            self._c[key] += n

    def __setitem__(self, key: str, value) -> None:
        if key not in self._c:
            raise KeyError(key)
        with self._lock:
            self._c[key] = value

    def reset(self) -> None:
        """Zero every counter (tests and benchmarks)."""
        with self._lock:
            for k in self._c:
                self._c[k] = 0

    # ---------------------------------------------------------------- read
    def __getitem__(self, key: str):
        return self._c[key]

    def __iter__(self):
        return iter(self._c)

    def __len__(self) -> int:
        return len(self._c)

    def __contains__(self, key: str) -> bool:
        return key in self._c

    def keys(self):
        return self._c.keys()

    def values(self):
        return self._c.values()

    def items(self):
        return self._c.items()

    def snapshot(self) -> dict:
        """A consistent point-in-time copy (taken under the lock)."""
        with self._lock:
            return dict(self._c)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Stats({self._c!r})"
