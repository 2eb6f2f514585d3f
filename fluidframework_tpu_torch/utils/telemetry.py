"""Named monotonic counters: the port's copy of ``CounterSet`` from
``fluidframework_tpu/utils/telemetry.py`` (and nothing else of that
module).  The catch-up cache tiers count with it."""

from __future__ import annotations

from typing import Dict


class CounterSet:
    """Named monotonic counters for steady-state subsystems (caches,
    retry loops): cheap bumps on the hot path, one dict snapshot for
    telemetry/bench reporting.  NOT internally synchronized — owners that
    bump from several threads do so under their own lock (the catch-up
    cache tiers hold their LRU lock across every bump)."""

    def __init__(self, *names: str) -> None:
        self._counts: Dict[str, int] = {name: 0 for name in names}

    def bump(self, name: str, by: int = 1) -> int:
        value = self._counts.get(name, 0) + by
        self._counts[name] = value
        return value

    def get(self, name: str) -> int:
        return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        return dict(self._counts)

    def delta(self, since: Dict[str, int]) -> Dict[str, int]:
        """Counts accumulated since an earlier :meth:`snapshot`: current
        minus ``since`` per counter, zero-delta counters dropped.
        Counters are monotonic, so a negative delta means ``since`` came
        from a different counter set — fail loudly, not quietly."""
        out: Dict[str, int] = {}
        for name, value in self.snapshot().items():
            diff = value - since.get(name, 0)
            if diff < 0:
                raise ValueError(
                    f"counter {name!r} went backwards ({diff}): 'since' "
                    "is not an earlier snapshot of this counter set")
            if diff:
                out[name] = diff
        return out
