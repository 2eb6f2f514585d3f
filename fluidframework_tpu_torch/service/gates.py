"""Canonical serving-gate registry: every ``Catchup.*`` / ``Server.*``
configuration gate the serving tier reads, with its canonical default.

Before this module, each gate's default lived at its read site — a
renamed gate or a drifted default was invisible until an operator's
config silently stopped doing anything.  Now the table below is the
single source of defaults; call sites read through the typed helpers
(which raise ``KeyError`` on an unregistered gate), and fluidlint's
``FL-DUR-GATE`` project rule statically cross-checks every
``Catchup.*``/``Server.*`` string literal in the package against this
table in both directions (unregistered read / registered-but-never-read).

Helpers take the :class:`~..utils.telemetry.ConfigProvider` explicitly —
this module holds no state and imports nothing from the serving tier, so
it can never participate in an import cycle.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

_OFF = ("off", "false", "0")
_ON = ("on", "true", "1")

#: gate key -> canonical default.  Grouped by subsystem; every entry is
#: read somewhere in the package (FL-DUR-GATE enforces it).
GATES: Dict[str, Any] = {
    # -- catch-up cache tiers (service/catchup.py) ------------------------
    "Catchup.Cache": "on",             # tier-1 folded-result cache
    "Catchup.CacheBytes": 256 << 20,
    "Catchup.PackCache": "on",         # tier-2 packed-chunk reuse
    "Catchup.PackCacheBytes": 192 << 20,
    "Catchup.DeltaDownload": "on",     # tier-0 digest-gated delta export
    "Catchup.DeltaCacheBytes": 256 << 20,
    "Catchup.DeviceResident": "on",    # tier-2.5 device-resident packs
    "Catchup.DeviceCacheBytes": 192 << 20,
    # -- fold orchestration (service/catchup.py) --------------------------
    "Catchup.JoinTimeout": 60.0,       # single-flight follower wait; 0 = never
    "Catchup.Mesh": "auto",            # multi-device fold mesh detection
    "Catchup.ProfileDir": None,        # profiler trace dir (off when unset)
    # -- admission / overload (service/server.py) -------------------------
    "Catchup.MaxInflight": 4,          # ctor arg overrides per-server
    "Catchup.ShedRetryFloor": 0.05,
    "Catchup.ShedRetryCap": 5.0,
    "Catchup.DegradeAfter": 2,         # consecutive-shed window -> degraded
    "Catchup.DegradedServe": "on",     # stale-summary serving under overload
    "Catchup.WarmJoinTimeout": 5.0,    # warm-lane single-flight bound
    # -- streaming fold (service/server.py) ---------------------
    "Catchup.Stream": "off",           # opt-in: sequencer-attached fold
    "Catchup.StreamCadence": 8,
    "Catchup.StreamRetention": 64,
    # -- server lifecycle (service/server.py) -----------------------------
    "Server.DrainRetryAfter": 0.5,     # shuttingDown nack retry_after
}


def default(key: str) -> Any:
    """The canonical default for ``key``; KeyError on an unregistered
    gate (registration here IS the contract FL-DUR-GATE checks)."""
    if key not in GATES:
        raise KeyError(f"gate {key!r} is not registered in GATES")
    return GATES[key]


def raw(config, key: str) -> Any:
    """The configured raw value, or the registry default when unset."""
    value = config.raw(key)
    return default(key) if value is None else value


def get_int(config, key: str, fallback: Optional[int] = None) -> int:
    """Int gate read; ``fallback`` (a constructor argument) overrides
    the registry default, never the operator's configured value."""
    base = int(default(key) if fallback is None else fallback)
    return config.get_int(key, base)


def get_float(config, key: str, fallback: Optional[float] = None) -> float:
    """Float gate read with the tolerant-parse semantics the serving
    tier always used: unset OR unparsable -> default."""
    base = float(default(key) if fallback is None else fallback)
    value = config.raw(key)
    try:
        return base if value is None else float(value)
    except (TypeError, ValueError):
        return base


def is_on(config, key: str) -> bool:
    """Boolean gate read honoring the default's polarity: an opt-out
    gate (default on) is on unless the value says off; an opt-in gate
    (default off) is off unless the value says on.  Unrecognized text
    therefore always resolves to the default."""
    base = str(default(key)).strip().lower()
    text = str(config.raw(key) or base).strip().lower()
    if base in _OFF:
        return text in _ON
    return text not in _OFF
