"""Undo-redo: revertible tracking over DDS change events.

Capability-equivalent of the reference's ``undo-redo`` package (SURVEY.md
§2.4: ``UndoRedoStackManager`` + sequence/map revertibles).

The manager subscribes to *local* change events on attached DDSes and
pushes a revertible per change (or per ``operation()`` group).  ``undo()``
applies the inverse as a fresh local op — concurrent remote edits merge
against it through the normal op path, exactly like the reference (undo is
"apply the inverse now", not "rewind history").

Supported revertibles:
- SharedMap / SharedCell:  restore the previous value (set/delete).
- SharedCounter:           increment by the negative delta.
- SharedString:            insert ↔ remove (positions re-resolved at the
  revert point via the recorded text — see caveat in ``_StringRevertible``).
- SharedTree:              changeset inversion (``undo_changeset``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional


class _Revertible:
    def __init__(self, fn: Callable[[], None]) -> None:
        self._fn = fn

    def revert(self) -> None:
        self._fn()


class UndoRedoStackManager:
    """Open/closeable operation groups of revertibles with undo/redo."""

    def __init__(self) -> None:
        self._undo: List[List[_Revertible]] = []
        self._redo: List[List[_Revertible]] = []
        self._open: Optional[List[_Revertible]] = None
        self._reverting = False
        self._subscriptions: List[tuple] = []

    # -- attaching DDSes -------------------------------------------------------

    def attach(self, dds) -> None:
        """Track local changes on a DDS (dispatched on its TYPE)."""
        type_name = dds.TYPE
        if type_name in ("map-tpu",):
            fn = dds.events.on("valueChanged",
                               lambda ev, local: self._on_map(dds, ev, local))
        elif type_name == "cell-tpu":
            fn = dds.events.on("valueChanged",
                               lambda ev, local: self._on_cell(dds, ev, local))
        elif type_name == "counter-tpu":
            fn = dds.events.on(
                "incremented",
                lambda ev, local: self._on_counter(dds, ev, local))
        elif type_name == "sequence-tpu":
            fn = dds.events.on(
                "sequenceDelta",
                lambda ev, local: self._on_string(dds, ev, local))
        elif type_name == "tree-tpu":
            fn = dds.events.on("changed",
                               lambda ev, local: self._on_tree(dds, ev, local))
        else:
            raise ValueError(f"no revertible support for {type_name!r}")
        self._subscriptions.append((dds, fn))

    # -- grouping --------------------------------------------------------------

    @contextlib.contextmanager
    def operation(self):
        """Group every tracked change inside into ONE undoable step."""
        self._open = []
        try:
            yield
        finally:
            group, self._open = self._open, None
            if group:
                self._undo.append(group)
                self._redo.clear()

    def _push(self, revertible: _Revertible) -> None:
        if self._reverting:
            return  # reverts are captured by undo()/redo() themselves
        if self._open is not None:
            self._open.append(revertible)
        else:
            self._undo.append([revertible])
            self._redo.clear()

    # -- undo / redo -----------------------------------------------------------

    @property
    def can_undo(self) -> bool:
        return bool(self._undo)

    @property
    def can_redo(self) -> bool:
        return bool(self._redo)

    def undo(self) -> bool:
        return self._revert(self._undo, self._redo)

    def redo(self) -> bool:
        return self._revert(self._redo, self._undo)

    def _revert(self, source: List, sink: List) -> bool:
        if not source:
            return False
        group = source.pop()
        inverse_group: List[_Revertible] = []
        self._reverting = True
        try:
            # Capture each revert's own inverse by re-recording through the
            # same event hooks — but _reverting suppresses _push, so hooks
            # record into inverse_group via _capture instead.
            self._capture_target = inverse_group
            for revertible in reversed(group):
                revertible.revert()
        finally:
            self._reverting = False
            self._capture_target = None
        if inverse_group:
            sink.append(inverse_group)
        return True

    _capture_target: Optional[List[_Revertible]] = None

    def _record(self, revertible: _Revertible) -> None:
        if self._reverting:
            if self._capture_target is not None:
                self._capture_target.append(revertible)
            return
        self._push(revertible)

    # -- per-DDS hooks (local changes only) ------------------------------------

    def _on_map(self, dds, ev: dict, local: bool) -> None:
        if not local:
            return
        key, prev = ev["key"], ev["previousValue"]
        existed = ev.get("previousExisted", prev is not None)

        def revert(key=key, prev=prev, existed=existed):
            if existed:
                dds.set(key, prev)
            elif dds.has(key):
                dds.delete(key)

        self._record(_Revertible(revert))

    def _on_cell(self, dds, ev: dict, local: bool) -> None:
        if not local:
            return
        prev = ev["previousValue"]

        def revert(prev=prev):
            if prev is None:
                dds.delete()
            else:
                dds.set(prev)

        self._record(_Revertible(revert))

    def _on_counter(self, dds, ev: dict, local: bool) -> None:
        if not local:
            return
        delta = ev["incrementAmount"]
        self._record(_Revertible(lambda: dds.increment(-delta)))

    def _on_string(self, dds, ev: dict, local: bool) -> None:
        if not local:
            return
        kind = ev["kind"]
        if kind == "insert":
            pos, text = ev["pos"], ev["text"]

            def revert(pos=pos, text=text):
                # Re-locate the inserted run: concurrent edits may have
                # shifted it.  Search near the original position first.
                current = dds.text
                idx = current.find(text, max(0, pos - 64))
                if idx < 0:
                    idx = current.find(text)
                if idx >= 0:
                    dds.remove_range(idx, idx + len(text))

            self._record(_Revertible(revert))
        elif kind == "remove":
            start, removed = ev["start"], ev["removedText"]
            self._record(_Revertible(
                lambda s=start, t=removed: dds.insert_text(
                    min(s, len(dds.text)), t)
            ))
        elif kind == "annotate":
            pass  # property layering: inverse annotate needs prior props

    def _on_tree(self, dds, ev: dict, local: bool) -> None:
        if not local:
            return
        cs = ev["changeset"]
        self._record(_Revertible(lambda: dds.undo_changeset(cs)))
