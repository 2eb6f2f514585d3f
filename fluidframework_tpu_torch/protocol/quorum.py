"""Quorum proposals: propose/accept over the sequenced stream.

Capability-equivalent of the reference's protocol-base ``Quorum``
(``IQuorumProposals``; SURVEY.md §1 layer 4, §2.1 protocol-base — upstream
paths UNVERIFIED, empty reference mount), the mechanism behind code-details
agreement: a client proposes ``(key, value)``; the proposal sequences at
seq S and stays *pending* until the minimumSequenceNumber reaches S —
i.e. every connected client has observed it — at which point it commits.

Convergence: acceptance is driven purely by sequenced state (proposal seq
vs stamped MSN), so every replica accepts the same proposals in the same
order at the same fold positions.  Concurrent proposals for one key both
accept in sequence order — the later seq wins the final value, on every
replica alike.

Both the pending set and the accepted values are part of protocol state:
they ride the ``.protocol`` summary blob and survive summarize/reload.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .messages import MessageType, SequencedMessage


class QuorumProposals:
    """Sequenced propose/accept state machine (one per container)."""

    def __init__(self) -> None:
        #: accepted: key -> [accept seq, value]
        self._values: Dict[str, list] = {}
        #: sequenced but unaccepted, ascending seq: [seq, key, value]
        self._pending: List[list] = []

    # -- the sequenced fold ----------------------------------------------------

    def observe(self, msg: SequencedMessage) -> None:
        """Feed every sequenced message: proposals enqueue, and any stamped
        MSN advance commits the pending prefix."""
        if msg.type is MessageType.PROPOSAL:
            self._pending.append(
                [msg.seq, msg.contents["key"], msg.contents["value"]]
            )
        self.advance(msg.min_seq)

    def advance(self, min_seq: int) -> None:
        while self._pending and self._pending[0][0] <= min_seq:
            seq, key, value = self._pending.pop(0)
            self._values[key] = [seq, value]

    # -- reads -----------------------------------------------------------------

    def get(self, key: str, default: Any = None) -> Any:
        entry = self._values.get(key)
        return entry[1] if entry is not None else default

    def accepted(self) -> Dict[str, Any]:
        return {key: entry[1] for key, entry in self._values.items()}

    def pending(self) -> List[dict]:
        return [
            {"seq": seq, "key": key, "value": value}
            for seq, key, value in self._pending
        ]

    def has(self, key: str) -> bool:
        return key in self._values

    # -- summary persistence ---------------------------------------------------

    def serialize(self) -> dict:
        return {
            "values": {k: list(v) for k, v in sorted(self._values.items())},
            "pending": [list(p) for p in self._pending],
        }

    @staticmethod
    def deserialize(obj: Optional[dict]) -> "QuorumProposals":
        """``None`` / missing blob (an N-1 summary written before proposals
        existed) loads as empty state."""
        q = QuorumProposals()
        if obj:
            q._values = {k: list(v) for k, v in obj.get("values", {}).items()}
            q._pending = [list(p) for p in obj.get("pending", [])]
        return q
