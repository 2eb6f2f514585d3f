"""Scribe — protocol-state keeper and summary validator.

Capability-equivalent of the reference's ``ScribeLambda`` + ``SummaryWriter``
(SURVEY.md §2.3/§3.3; upstream paths UNVERIFIED — empty reference mount):
watches the sequenced stream for ``summarize`` ops, validates them against
storage and the current protocol state, records the accepted commit, and
stamps a server-originated ``summaryAck`` (or ``summaryNack`` with a reason)
back into the stream so every client converges on the same
last-acked-summary.
"""

from __future__ import annotations

from typing import Optional

from ..protocol.messages import MessageType, SequencedMessage
from ..protocol.sequencer import Sequencer
from ..protocol.summary import SummaryStorage, SummaryTree


class Scribe:
    """Per-document summary validation + ack."""

    def __init__(
        self, doc_id: str, sequencer: Sequencer, storage: SummaryStorage
    ) -> None:
        self.doc_id = doc_id
        self._sequencer = sequencer
        self._storage = storage
        self.last_acked_handle: Optional[str] = None
        self.last_acked_seq = 0  # ref_seq covered by the accepted summary
        self.acks = 0
        self.nacks = 0
        sequencer.subscribe(self._on_message)

    # -- the lambda ------------------------------------------------------------

    def _on_message(self, msg: SequencedMessage) -> None:
        if msg.type is not MessageType.SUMMARIZE:
            return
        handle = msg.contents.get("handle")
        ref_seq = msg.contents.get("seq", -1)
        reason = self._validate(handle, ref_seq, msg.seq)
        if reason is None:
            self.last_acked_handle = handle
            self.last_acked_seq = ref_seq
            self.acks += 1
            ack = {"handle": handle, "seq": ref_seq, "summarizeSeq": msg.seq}
            # Stamp the git-style commit this summary landed as (the
            # reference's ack carries the service's summary commit handle).
            commit = self._storage.commit_for(self.doc_id, handle, ref_seq)
            if commit is not None:
                ack["commit"] = commit
            self._sequencer.server_message(MessageType.SUMMARY_ACK, ack)
        else:
            self.nacks += 1
            self._sequencer.server_message(
                MessageType.SUMMARY_NACK,
                {"handle": handle, "seq": ref_seq, "reason": reason,
                 "summarizeSeq": msg.seq},
            )

    def _validate(
        self, handle: Optional[str], ref_seq: int, summarize_seq: int
    ) -> Optional[str]:
        """None = accept; otherwise the nack reason."""
        if not handle:
            return "missing summary handle"
        try:
            node = self._storage.read(handle)
        except KeyError:
            return "unknown summary handle (not uploaded)"
        if not isinstance(node, SummaryTree):
            return "summary handle does not address a tree"
        if ref_seq < 0 or ref_seq >= summarize_seq:
            return "summary reference sequence out of range"
        if ref_seq < self.last_acked_seq:
            return "summary older than last accepted summary"
        return None

    def replay(self, msg: SequencedMessage) -> None:
        """Crash-resume: reconstruct ack state from log messages stamped
        after the checkpoint (acks are durable; re-validating would
        double-stamp them)."""
        if msg.type is MessageType.SUMMARY_ACK:
            self.last_acked_handle = msg.contents["handle"]
            self.last_acked_seq = msg.contents["seq"]
            self.acks += 1
        elif msg.type is MessageType.SUMMARY_NACK:
            self.nacks += 1

    # -- checkpoint (crash-resume, like Deli's) --------------------------------

    def checkpoint(self) -> dict:
        return {
            "lastAckedHandle": self.last_acked_handle,
            "lastAckedSeq": self.last_acked_seq,
            "acks": self.acks,
            "nacks": self.nacks,
        }

    def restore(self, state: dict) -> None:
        self.last_acked_handle = state["lastAckedHandle"]
        self.last_acked_seq = state["lastAckedSeq"]
        self.acks = state["acks"]
        self.nacks = state["nacks"]
