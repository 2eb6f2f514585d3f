"""Presence: ephemeral per-user state over signals (never sequenced).

Capability-equivalent of the reference's ``presence`` package (SURVEY.md
§2.4: workspaces of per-client values rides signals, not ops — nothing
persists, nothing reaches the op log).

Protocol: every local update broadcasts
``{"presence": workspace, "key": ..., "value": ...}``.  A newly attached
presence instance broadcasts a ``presenceRequest``; every peer re-sends
its local values (targeted at the requester), so late joiners see current
presence without any durable state."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ..utils.events import EventEmitter


class PresenceWorkspace:
    """One named bag of per-client ephemeral values (e.g. cursors)."""

    def __init__(self, presence: "Presence", name: str) -> None:
        self._presence = presence
        self.name = name
        self.events = EventEmitter()  # "updated" (client_id, key, value)
        self._local: Dict[str, Any] = {}
        self._remote: Dict[str, Dict[str, Any]] = {}  # client -> {key: val}

    # -- local side ------------------------------------------------------------

    def set_local(self, key: str, value: Any) -> None:
        self._local[key] = value
        self._presence._broadcast(self.name, key, value)

    def get_local(self, key: str, default: Any = None) -> Any:
        return self._local.get(key, default)

    # -- remote side -----------------------------------------------------------

    def get(self, client_id: str, key: str, default: Any = None) -> Any:
        return self._remote.get(client_id, {}).get(key, default)

    def clients(self):
        return sorted(self._remote)

    def all(self, key: str) -> Dict[str, Any]:
        return {c: vals[key] for c, vals in sorted(self._remote.items())
                if key in vals}

    # -- wire ------------------------------------------------------------------

    def _apply(self, client_id: str, key: str, value: Any) -> None:
        self._remote.setdefault(client_id, {})[key] = value
        self.events.emit("updated", client_id, key, value)

    def _drop_client(self, client_id: str) -> None:
        if self._remote.pop(client_id, None) is not None:
            self.events.emit("clientLeft", client_id)

    def _resend_local(self, target: Optional[str]) -> None:
        for key, value in self._local.items():
            self._presence._broadcast(self.name, key, value, target=target)


class Presence:
    """Attach to a FluidContainer (or anything with ``submit_signal`` /
    ``on_signal`` / ``client_id``)."""

    def __init__(self, container) -> None:
        self._container = container
        self._workspaces: Dict[str, PresenceWorkspace] = {}
        container.on_signal(self._on_signal)
        # Ask peers for their current state.
        container.submit_signal({"presenceRequest": True})

    def workspace(self, name: str) -> PresenceWorkspace:
        ws = self._workspaces.get(name)
        if ws is None:
            ws = PresenceWorkspace(self, name)
            self._workspaces[name] = ws
        return ws

    # -- wire ------------------------------------------------------------------

    def _broadcast(self, workspace: str, key: str, value: Any,
                   target: Optional[str] = None) -> None:
        self._container.submit_signal(
            {"presence": workspace, "key": key, "value": value},
            target_client_id=target,
        )

    def _on_signal(self, signal: dict) -> None:
        target = signal.get("targetClientId")
        me = self._container.client_id
        if target is not None and target != me:
            return
        sender = signal.get("clientId")
        if sender == me:
            return  # our own broadcast
        content = signal.get("content") or {}
        if content.get("presenceRequest"):
            for ws in self._workspaces.values():
                ws._resend_local(sender)
            return
        name = content.get("presence")
        if name is None:
            return
        self.workspace(name)._apply(sender, content["key"],
                                    content["value"])
