"""Reduce a ``torch.profiler`` trace of the window to device numbers.

The window is traced with CPU and CUDA activity and one
``record_function`` span a pass (``PASS_SPAN``).  From the exported
Chrome trace this takes:

- the device's activity: every kernel, copy and memset, merged into busy
  intervals;
- ``window_s``: first pass start to last pass end; ``busy_s``: the busy
  time inside it;
- ``by_name``: device seconds by operation name (``device_ops`` of the
  breakdown is its top ten);
- the idle time by what the host was doing: inside a pass before its
  first device operation (``entry.head``: the first chunk's pack), after
  its last (``entry.tail``: the last chunks' extract), between (``entry.mid``),
  and outside every pass (``harness``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

PASS_SPAN = "portbench.pass"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _clip(busy, lo, hi) -> List[Tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in busy if e > lo and s < hi]


def reduce_trace(path: str) -> Dict:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device: List[Tuple[float, float]] = []
    by_name: Dict[str, float] = {}
    passes: List[Tuple[float, float]] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        cat = e.get("cat", "")
        if cat in _DEVICE_CATS:
            device.append((ts, ts + dur))
            name = e.get("name", "?")
            by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
        elif cat == "user_annotation" and e.get("name") == PASS_SPAN:
            passes.append((ts, ts + dur))
    if not passes:
        return {}
    passes.sort()
    lo, hi = passes[0][0], passes[-1][1]
    busy = _clip(_merge(device), lo, hi)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    idle = {"entry.head": 0.0, "entry.mid": 0.0, "entry.tail": 0.0,
            "harness": 0.0}
    in_passes = 0.0
    for ps, pe in passes:
        inside = _clip(busy, ps, pe)
        span = pe - ps
        in_passes += span
        if not inside:
            idle["entry.head"] += span * 1e-6
            continue
        head = inside[0][0] - ps
        tail = pe - inside[-1][1]
        on = sum(e - s for s, e in inside)
        idle["entry.head"] += head * 1e-6
        idle["entry.tail"] += tail * 1e-6
        idle["entry.mid"] += (span - head - tail - on) * 1e-6
    busy_outside = busy_s - sum(
        sum(e - s for s, e in _clip(busy, ps, pe)) for ps, pe in passes) * 1e-6
    idle["harness"] = max(0.0, (hi - lo - in_passes) * 1e-6 - busy_outside)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy_s,
        "by_name": by_name,
        "device_ops": [[n, s] for n, s in device_ops],
        "idle_gaps": sorted(([k, v] for k, v in idle.items() if v > 0),
                            key=lambda kv: -kv[1]),
    }


def kernel_seconds(reduced: Dict, name: str) -> float:
    """Device seconds of the kernels whose name contains ``name``."""
    by_name = (reduced or {}).get("by_name", {})
    return sum(s for n, s in by_name.items() if name in n)
