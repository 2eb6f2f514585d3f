"""Op model, sequencing and canonical summary trees (copies of the JAX
package's protocol modules: messages, the sequencer and its quorum, the
wire codecs, summaries)."""

from .messages import (
    UNASSIGNED_SEQ,
    MessageType,
    RawOperation,
    SequencedMessage,
)
from .sequencer import ClientConnection, Sequencer
from .summary import (
    SummaryBlob,
    SummaryCommit,
    SummaryTree,
    SummaryStorage,
    canonical_json,
)

__all__ = [
    "UNASSIGNED_SEQ",
    "MessageType",
    "RawOperation",
    "SequencedMessage",
    "ClientConnection",
    "Sequencer",
    "SummaryBlob",
    "SummaryCommit",
    "SummaryTree",
    "SummaryStorage",
    "canonical_json",
]
