"""Summarization: election, heuristics, upload, ack tracking.

Capability-equivalent of the reference's summary stack (SURVEY.md §3.3:
``SummaryManager`` → ``OrderedClientElection`` → ``RunningSummarizer``
heuristics → ``submitSummary`` → storage upload → "summarize" op → ack).
One client — the oldest in the quorum — summarizes; everyone else
tracks acks so any client can take over on re-election."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..protocol.messages import MessageType, RawOperation, SequencedMessage, NackError
from ..protocol.summary import SummaryStorage
from .container import ContainerRuntime, OrderedClientElection

__all__ = ["SummarizerOptions", "SummaryManager", "OrderedClientElection"]


@dataclasses.dataclass
class SummarizerOptions:
    """RunningSummarizer heuristics (the reference's ISummaryConfiguration
    capability: opsSinceLastSummary / maxOps thresholds)."""

    ops_per_summary: int = 50    # summarize every N sequenced ops
    min_ops: int = 1             # never summarize with fewer new ops
    #: record last_full_bytes alongside incremental uploads (costs one
    #: full-tree encode per summary; disable for very large documents)
    track_upload_ratio: bool = True
    #: after a summary NACK, retry once this many ops have sequenced —
    #: doubling per consecutive nack (deterministic in-proc backoff),
    #: resetting on the next ack
    nack_retry_ops: int = 4


class SummaryManager:
    """Watches the op stream on one client; when that client is elected and
    the heuristics fire, writes a summary and announces it.

    Wire-in: ``manager = SummaryManager(runtime, storage, doc_id)`` then the
    runtime's ``message_observers`` hook drives it — no polling."""

    def __init__(
        self,
        runtime: ContainerRuntime,
        storage: SummaryStorage,
        doc_id: str,
        options: Optional[SummarizerOptions] = None,
    ) -> None:
        self.runtime = runtime
        self.storage = storage
        self.doc_id = doc_id
        self.options = options or SummarizerOptions()
        self.last_summary_seq = 0
        self.last_ack_handle: Optional[str] = None
        # Scribe-confirmed state (set only when a Scribe is in the loop and
        # stamps summaryAck/summaryNack back into the stream).
        self.last_acked_handle: Optional[str] = None
        self.last_acked_seq = 0
        self.nacks_received = 0
        self.consecutive_nacks = 0
        self.ops_since_summary = 0
        self.summaries_written = 0
        # Incremental-upload accounting (set by summarize_now).
        self.last_upload_bytes = 0
        self.last_full_bytes = 0
        runtime.message_observers.append(self._on_message)

    # -- the message hook ------------------------------------------------------

    @property
    def election(self) -> OrderedClientElection:
        return self.runtime.election

    def _on_message(self, msg: SequencedMessage) -> None:
        if msg.type is MessageType.OP:
            self.ops_since_summary += 1
        elif msg.type is MessageType.SUMMARIZE:
            # Every client tracks announced summaries (for takeover).  With
            # no Scribe in the loop, sequencing the summarize op is the
            # acceptance point; with one, summaryAck below confirms it.
            self.last_summary_seq = msg.contents["seq"]
            self.last_ack_handle = msg.contents["handle"]
            self.ops_since_summary = 0
        elif msg.type is MessageType.SUMMARY_ACK:
            self.last_acked_handle = msg.contents["handle"]
            self.last_acked_seq = msg.contents["seq"]
            self.consecutive_nacks = 0
        elif msg.type is MessageType.SUMMARY_NACK:
            # No immediate retry (a persistent nack reason would loop);
            # the next ops_per_summary window naturally re-attempts — the
            # deterministic in-proc analogue of the reference's backoff.
            # Roll the takeover baseline back to the last *accepted* summary
            # so a re-elected summarizer never builds on the rejected one.
            self.nacks_received += 1
            self.consecutive_nacks += 1
            self.last_summary_seq = self.last_acked_seq
            self.last_ack_handle = self.last_acked_handle
        # Normal cadence, or — after a NACK — an exponential-backoff
        # retry window (nack_retry_ops * 2^(nacks-1) sequenced ops), so a
        # transient rejection re-attempts without waiting out the full
        # summary window and a persistent one cannot hot-loop.
        threshold = self.options.ops_per_summary
        if self.consecutive_nacks:
            threshold = min(threshold, self.options.nack_retry_ops
                            * (2 ** (self.consecutive_nacks - 1)))
        if (
            self._is_summarizer
            and msg.type is not MessageType.SUMMARIZE
            and self.ops_since_summary >= threshold
            and self.ops_since_summary >= self.options.min_ops
        ):
            self.summarize_now()

    @property
    def _is_summarizer(self) -> bool:
        return (
            self.runtime.is_attached
            and self.election.elected == self.runtime.client_id
        )

    # -- the summarize action --------------------------------------------------

    def summarize_now(self) -> Optional[str]:
        """Write + upload + announce one summary; returns its handle.

        Uploads INCREMENTALLY against the last announced summary when its
        tree is still in the store: unchanged subtrees ride as handle
        references (the reference's incremental-summary capability), and
        ``last_upload_bytes`` / ``last_full_bytes`` record the saving."""
        from ..protocol.summary import (
            canonical_json,
            tree_to_incremental_obj,
            tree_to_obj,
        )

        tree = self.runtime.summarize()
        ref_seq = self.runtime.ref_seq
        if self.options.track_upload_ratio:
            # Telemetry denominator: serializing the FULL tree costs the
            # O(tree) encode the incremental path avoids — flip the option
            # off for very large documents.
            self.last_full_bytes = len(canonical_json(tree_to_obj(tree)))
        else:
            self.last_full_bytes = 0
        base = None
        has = getattr(self.storage, "has", None)
        upload_obj = getattr(self.storage, "upload_obj", None)
        if has is not None and upload_obj is not None \
                and self.last_ack_handle is not None \
                and has(self.last_ack_handle):
            base = self.storage.read(self.last_ack_handle)
        if base is not None:
            obj = tree_to_incremental_obj(tree, base)
            self.last_upload_bytes = len(canonical_json(obj))
            handle = upload_obj(self.doc_id, obj, ref_seq)
        else:
            # Driver storages without incremental support, or no usable
            # base: full upload.
            self.last_upload_bytes = self.last_full_bytes
            handle = self.storage.upload(self.doc_id, tree, ref_seq)
        self.summaries_written += 1
        try:
            self.runtime._service.submit(
                RawOperation(
                    client_id=self.runtime.client_id,
                    client_seq=self._next_summary_client_seq(),
                    ref_seq=ref_seq,
                    type=MessageType.SUMMARIZE,
                    contents={"handle": handle, "seq": ref_seq},
                )
            )
        except NackError:
            # The announcement was refused (throttle / retryAfter hold).
            # The uploaded tree is not lost — a later attempt re-announces;
            # count it as a nack so the retry follows the backoff window
            # instead of hot-looping inside the delivery observer.
            self.consecutive_nacks += 1
            self.nacks_received += 1
            self.ops_since_summary = 0
            return None
        return handle

    def _next_summary_client_seq(self) -> int:
        # Summary ops ride the same per-client sequence space as channel
        # ops so the sequencer's dedup floor stays consistent.
        self.runtime._client_seq += 1
        return self.runtime._client_seq
