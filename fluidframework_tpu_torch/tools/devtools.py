"""Runtime inspector — the devtools capability (SURVEY.md §2.4).

``inspect_runtime`` renders one live ContainerRuntime as a JSON-safe
snapshot a host can surface in a debug panel: connection + window state,
quorum membership and propose/accept state, per-datastore channel types
with per-channel quick views, pending (un-acked) work, and summarizer
stats when a SummaryManager is attached.  Read-only: inspecting never
mutates runtime state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


def _channel_view(channel) -> Dict[str, Any]:
    view: Dict[str, Any] = {"type": getattr(channel, "TYPE", "?")}
    text = getattr(channel, "text", None)
    if isinstance(text, str):
        view["length"] = len(text)
        view["preview"] = text[:80]
    if hasattr(channel, "row_count"):
        view["rows"] = channel.row_count
        view["cols"] = channel.col_count
    if hasattr(channel, "_kernel") and hasattr(channel._kernel, "data"):
        data = channel._kernel.data
        view["keys"] = len(data)
        view["preview"] = dict(list(sorted(data.items()))[:8])
    if hasattr(channel, "value"):
        try:
            view["value"] = channel.value
        except Exception:
            pass
    pending = getattr(channel, "_pending_groups", None)
    if pending is not None:
        view["pendingOps"] = len(pending)
    return view


def inspect_runtime(runtime, summary_manager=None) -> Dict[str, Any]:
    """A read-only snapshot of a live runtime for debug surfaces."""
    out: Dict[str, Any] = {
        "clientId": runtime.client_id,
        "attached": runtime.is_attached,
        "refSeq": runtime.ref_seq,
        "minSeq": runtime.min_seq,
        "inboundQueued": len(runtime._inbound),
        "outboxOps": len(runtime._outbox),
        "pendingWireMessages": len(runtime._pending_wire),
        "quorum": runtime.election.quorum,
        "elected": runtime.election.elected,
        "proposals": {
            "accepted": runtime.quorum_proposals.accepted(),
            "pending": runtime.quorum_proposals.pending(),
        },
        "datastores": {},
    }
    for ds_id, ds in sorted(runtime.datastores.items()):
        out["datastores"][ds_id] = {
            "rooted": ds.rooted,
            "channels": {
                channel_id: _channel_view(channel)
                for channel_id, channel in sorted(ds.channels.items())
            },
        }
    dm = getattr(runtime, "_service", None)
    state = getattr(dm, "state", None)
    if state is not None:
        out["connection"] = {
            "state": state.value,
            "nacks": getattr(dm, "nacks", 0),
            "gapsRepaired": getattr(dm, "gaps_repaired", 0),
            "lastDeliveredSeq": getattr(dm, "last_delivered_seq", 0),
        }
    if summary_manager is not None:
        out["summarizer"] = {
            "isSummarizer": summary_manager._is_summarizer,
            "summariesWritten": summary_manager.summaries_written,
            "opsSinceSummary": summary_manager.ops_since_summary,
            "nacksReceived": summary_manager.nacks_received,
            "lastAckedHandle": summary_manager.last_acked_handle,
            "lastUploadBytes": summary_manager.last_upload_bytes,
        }
    return out
