"""Op attribution — who wrote what, when (SURVEY.md §1 layer 8).

Capability-equivalent of the reference's ``@fluid-experimental/attributor``
(upstream path UNVERIFIED — empty reference mount): a container-level map
``seq -> (user, timestamp)`` recorded for every sequenced op, serialized
into the container summary so attribution survives summarize/load
round-trips, and resolved from DDS reads (a SharedString segment's insert
seq, a SharedTree node's insert/value seq).

Representation is COLUMNAR, not per-op dicts: ascending delta-encoded
seqs, an interned client table with per-op indices, and delta-encoded
integer timestamps.  For the common sequential-editing case every column
delta is a small non-negative int, so the canonical-JSON blob stays
compact at tens of thousands of ops — and the columns are exactly the
arrays a future device-side attribution join would upload.

ACCEPTED v1 LIMITATION (ADVICE r4): the table grows one row per sequenced
op for the document's lifetime and is re-serialized whole into every
summary.  Sound pruning must drop only rows no DDS attribution key can
still reference — which requires a deterministic referenced-seq census
across every datastore, replicated bit-identically by the catch-up
service's summary builder (summaries must stay byte-identical across
replicas and the service).  Until that census exists, attribution-enabled
documents pay O(lifetime ops) summary bytes (a few bytes/op after delta
encoding); the option defaults off.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from ..protocol.messages import MessageType, SequencedMessage


class Attributor:
    """Seq-keyed attribution log with columnar summary serialization."""

    def __init__(self) -> None:
        self._seqs: List[int] = []        # ascending op seqs
        self._client_idx: List[int] = []  # index into _clients per op
        self._timestamps: List[int] = []  # stamped sequencer clock per op
        self._clients: List[str] = []     # interned client/user table
        self._client_map: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._seqs)

    # -- record side -----------------------------------------------------------

    def observe(self, msg: SequencedMessage) -> None:
        """Record a sequenced op's attribution.  Idempotent under replay
        (a seq at or below the newest recorded one is ignored — catch-up
        tails overlapping a loaded summary re-deliver ops)."""
        if msg.type is not MessageType.OP or msg.client_id is None:
            return
        if self._seqs and msg.seq <= self._seqs[-1]:
            return
        idx = self._client_map.get(msg.client_id)
        if idx is None:
            idx = len(self._clients)
            self._clients.append(msg.client_id)
            self._client_map[msg.client_id] = idx
        self._seqs.append(msg.seq)
        self._client_idx.append(idx)
        self._timestamps.append(int(msg.timestamp))

    # -- read side -------------------------------------------------------------

    def get(self, seq: int) -> Optional[dict]:
        """Attribution for the op stamped ``seq``:
        ``{"user", "timestamp", "seq"}`` or None if unknown (detached
        inserts, pre-attribution summaries, server messages)."""
        i = bisect.bisect_left(self._seqs, seq)
        if i == len(self._seqs) or self._seqs[i] != seq:
            return None
        return {
            "user": self._clients[self._client_idx[i]],
            "timestamp": self._timestamps[i],
            "seq": seq,
        }

    # -- summary round-trip ----------------------------------------------------

    def serialize(self) -> dict:
        def deltas(xs: List[int]) -> List[int]:
            prev, out = 0, []
            for x in xs:
                out.append(x - prev)
                prev = x
            return out

        return {
            "v": 1,
            "clients": list(self._clients),
            "seqD": deltas(self._seqs),
            "client": list(self._client_idx),
            "tsD": deltas(self._timestamps),
        }

    @staticmethod
    def deserialize(state: Optional[dict]) -> "Attributor":
        out = Attributor()
        if not state:
            return out  # pre-attribution summary: start empty
        if state.get("v", 1) > 1:
            raise ValueError(f"attribution format {state['v']} unsupported")

        def undeltas(ds: List[int]) -> List[int]:
            acc, out_ = 0, []
            for d in ds:
                acc += d
                out_.append(acc)
            return out_

        out._clients = list(state["clients"])
        out._client_map = {c: i for i, c in enumerate(out._clients)}
        out._seqs = undeltas(state["seqD"])
        out._client_idx = list(state["client"])
        out._timestamps = undeltas(state["tsD"])
        return out
