"""Host-side interning: strings/JSON values ↔ dense int32 ids.

The device kernels operate on int32 tensors only; everything symbolic (client
ids, map keys, property keys, JSON values, text payloads) is interned on the
host during packing and restored during summary extraction.  Interning order
is deterministic (first-appearance in op order) so packing itself is
reproducible.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

from ..protocol.summary import canonical_json


def next_bucket(n: int, floor: int = 64) -> int:
    """Round up to a power-of-two bucket so jitted kernels see a small, stable
    set of shapes instead of recompiling per batch."""
    size = floor
    while size < n:
        size *= 2
    return size


def next_bucket_fine(n: int, floor: int = 64) -> int:
    """Round up to the {f, 1.5f, 2f, 3f, 4f, 6f, ...} ladder — powers of two
    plus their 1.5× midpoints.  Twice the shape variants of
    :func:`next_bucket`, but up to 25% less padding: use it for dimensions
    whose cost is per-element on the hot path (device→host transfer bytes,
    scan length), not for axes that must divide a mesh."""
    size = floor
    while True:
        if n <= size:
            return size
        if n <= size * 3 // 2:
            return size * 3 // 2
        size *= 2


class Interner:
    """Dense id assignment by first appearance."""

    def __init__(self) -> None:
        self._by_key: Dict[Any, int] = {}
        self.values: List[Any] = []

    def intern(self, value: Any) -> int:
        key = self._hashable(value)
        idx = self._by_key.get(key)
        if idx is None:
            idx = len(self.values)
            self._by_key[key] = idx
            self.values.append(value)
        return idx

    def lookup(self, idx: int) -> Any:
        return self.values[idx]

    def __contains__(self, value: Any) -> bool:
        return self._hashable(value) in self._by_key

    def __len__(self) -> int:
        return len(self.values)

    @staticmethod
    def _hashable(value: Any):
        if isinstance(value, (dict, list)):
            return canonical_json(value)
        return value


class TextArena:
    """Append-only byte arena for text payloads; device state references
    (start, len) spans.  Kept host-side: the device tracks structure, not
    bytes (SURVEY.md §7 design stance)."""

    def __init__(self) -> None:
        self._chunks: List[str] = []
        self._length = 0
        self._finalize_lock = threading.Lock()

    def append(self, text: str) -> int:
        """Returns the start offset of the appended text (in characters)."""
        start = self._length
        self._chunks.append(text)
        self._length += len(text)
        return start

    def finalize(self) -> str:
        # Append-safe compaction: the catch-up pack cache shares one
        # arena between a cached chunk being extracted (finalize) and a
        # suffix extension appending new text.  Join a snapshot prefix
        # and splice it back over exactly those elements — a chunk
        # appended mid-join lands at index >= n and survives the slice
        # assignment (each list op is atomic under the GIL), where the
        # old wholesale `self._chunks = [joined]` would silently drop it.
        # Finalizers take turns: a chunk's extract slices finalize its
        # arena at once, and a second splice over a snapshot taken before
        # the first would drop what was appended in between.
        with self._finalize_lock:
            n = len(self._chunks)
            if n == 0:
                return ""
            if n > 1:
                joined = "".join(self._chunks[:n])
                self._chunks[:n] = [joined]
                return joined
            return self._chunks[0]

    def slice(self, start: int, length: int) -> str:
        return self.finalize()[start : start + length]

    def __len__(self) -> int:
        return self._length
