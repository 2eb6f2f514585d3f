"""Telemetry: logger tree, performance events, monitoring context.

Capability-equivalent of the reference's ``telemetry-utils`` (SURVEY.md
§2.4/§5: ``createChildLogger``, ``PerformanceEvent.timedExec``,
``MonitoringContext``/``IConfigProvider`` feature gates; upstream paths
UNVERIFIED — empty reference mount).

The logger contract is one duck-typed method — ``send(event: dict)`` —
so hosts plug in anything (stdout, a file, a metrics pipe).  Loggers
compose into a tree: children prefix a namespace and merge inherited
properties, exactly the host-injected shape the reference uses."""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional


class NullLogger:
    """Swallow everything (the default when hosts inject nothing)."""

    def send(self, event: dict) -> None:
        pass


class CollectingLogger:
    """Keep events in memory (tests, devtools)."""

    def __init__(self) -> None:
        self.events: List[dict] = []

    def send(self, event: dict) -> None:
        self.events.append(event)


class StreamLogger:
    """One JSON line per event (winston/Lumberjack-style sink)."""

    def __init__(self, stream=None) -> None:
        self._stream = stream if stream is not None else sys.stderr

    def send(self, event: dict) -> None:
        self._stream.write(json.dumps(event, sort_keys=True,
                                      default=str) + "\n")


class ChildLogger:
    """Namespace prefix + inherited properties over a base logger."""

    def __init__(self, base, namespace: str,
                 properties: Optional[Dict[str, Any]] = None) -> None:
        self._base = base
        self.namespace = namespace
        self.properties = properties or {}

    def send(self, event: dict) -> None:
        out = dict(self.properties)
        out.update(event)
        name = event.get("eventName", "")
        out["eventName"] = f"{self.namespace}:{name}" if name \
            else self.namespace
        self._base.send(out)


def create_child_logger(base=None, namespace: str = "",
                        properties: Optional[Dict[str, Any]] = None):
    return ChildLogger(base if base is not None else NullLogger(),
                       namespace, properties)


class PerformanceEvent:
    """Duration-measuring event: emits <name>_start / <name>_end (or
    <name>_cancel with the error) around a phase — the reference's
    ``PerformanceEvent.timedExec``."""

    @staticmethod
    @contextlib.contextmanager
    def timed_exec(logger, event_name: str, **properties):
        start = time.perf_counter()
        logger.send({"eventName": f"{event_name}_start", **properties})
        holder = {"extra": {}}
        try:
            yield holder
        except BaseException as err:
            logger.send({
                "eventName": f"{event_name}_cancel",
                "durationMs": round((time.perf_counter() - start) * 1000, 3),
                "error": repr(err),
                **properties,
            })
            raise
        logger.send({
            "eventName": f"{event_name}_end",
            "durationMs": round((time.perf_counter() - start) * 1000, 3),
            **properties,
            **holder["extra"],
        })


#: what :func:`span` returns while no profiler runs (one shared instance)
NULL_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` span while a
    ``torch.profiler`` session is active, else :data:`NULL_SPAN`: the
    guard costs a fraction of a microsecond, the span ~13 µs, so a hot
    path pays for it only when it is traced.  The span lands in the trace
    on the profiler's clock, beside the device events."""
    import torch

    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return NULL_SPAN


class CounterSet:
    """Named monotonic counters for steady-state subsystems (caches,
    retry loops): cheap bumps on the hot path, one dict snapshot for
    telemetry/bench reporting.  NOT internally synchronized — owners that
    bump from several threads do so under their own lock (the catch-up
    cache holds its LRU lock across every bump)."""

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
        minus ``since`` per counter, zero-delta counters dropped — the
        one subtraction every per-phase attribution and replay-identity
        assertion shares instead of hand-rolling dict arithmetic.
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


class LockedCounterSet(CounterSet):
    """A :class:`CounterSet` with its own lock: for subsystems whose
    bumps arrive from several threads with no natural owning lock (the
    fault injector fires from client threads, the TCP reader, and server
    executor threads; retry loops bump from any caller).  Snapshot is a
    consistent point-in-time copy."""

    def __init__(self, *names: str) -> None:
        super().__init__(*names)
        self._lock = threading.Lock()

    def bump(self, name: str, by: int = 1) -> int:
        with self._lock:
            return super().bump(name, by)

    def get(self, name: str) -> int:
        with self._lock:
            return super().get(name)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return super().snapshot()


class IngressMeter:
    """Ingress-stage accounting for batched op submission: wall time,
    op/batch counts split by path (columnar vs boxed), and the wire
    footprint of encoded/decoded column batches.

    Wall-clock derived — deliberately OUTSIDE every replay-identity
    surface (two bit-identical runs will disagree on wall time); callers
    report it next to, never inside, their deterministic counters.
    """

    def __init__(self) -> None:
        self.wall_sec = 0.0
        self.columnar_ops = 0
        self.boxed_ops = 0
        self.batches = 0
        self.encode_bytes = 0
        self.decode_bytes = 0

    @contextlib.contextmanager
    def timed(self):
        """Accumulate the elapsed wall time of one ingress call."""
        start = time.perf_counter()
        try:
            yield self
        finally:
            self.wall_sec += time.perf_counter() - start

    @property
    def ops(self) -> int:
        return self.columnar_ops + self.boxed_ops

    @property
    def us_per_op(self) -> float:
        return (self.wall_sec * 1e6 / self.ops) if self.ops else 0.0

    def snapshot(self) -> Dict[str, float]:
        """The bench-report shape (``ingress_us_per_op`` et al.)."""
        return {
            "ingress_us_per_op": round(self.us_per_op, 3),
            "ingress_wall_sec": round(self.wall_sec, 6),
            "ingress_ops": self.ops,
            "columnar_ops": self.columnar_ops,
            "boxed_ops": self.boxed_ops,
            "batches": self.batches,
            "encode_bytes": self.encode_bytes,
            "decode_bytes": self.decode_bytes,
        }


class ConfigProvider:
    """Layered feature gates: explicit dict over environment variables
    (``FLUID_TPU_<KEY>``), read through typed getters — the reference's
    IConfigProvider resolved via MonitoringContext."""

    ENV_PREFIX = "FLUID_TPU_"

    def __init__(self, settings: Optional[Dict[str, Any]] = None) -> None:
        self._settings = dict(settings or {})

    def raw(self, key: str) -> Optional[Any]:
        if key in self._settings:
            return self._settings[key]
        env_key = self.ENV_PREFIX + key.replace(".", "_").upper()
        return os.environ.get(env_key)

    def get_bool(self, key: str, default: bool = False) -> bool:
        value = self.raw(key)
        if value is None:
            return default
        if isinstance(value, bool):
            return value
        return str(value).strip().lower() in ("1", "true", "yes", "on")

    def get_int(self, key: str, default: int = 0) -> int:
        value = self.raw(key)
        try:
            return int(value)
        except (TypeError, ValueError):
            return default

    def get_str(self, key: str, default: str = "") -> str:
        value = self.raw(key)
        return default if value is None else str(value)


class MonitoringContext:
    """logger + config bundle threaded through subsystems."""

    def __init__(self, logger=None,
                 config: Optional[ConfigProvider] = None) -> None:
        self.logger = logger if logger is not None else NullLogger()
        self.config = config if config is not None else ConfigProvider()

    def child(self, namespace: str,
              properties: Optional[Dict[str, Any]] = None
              ) -> "MonitoringContext":
        return MonitoringContext(
            create_child_logger(self.logger, namespace, properties),
            self.config,
        )
