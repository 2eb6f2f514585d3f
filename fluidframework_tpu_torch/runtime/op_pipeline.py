"""Outbound op pipeline: batch compression and chunking.

Capability-equivalent of the reference's ``opLifecycle/`` (``OpCompressor``,
``OpSplitter``; SURVEY.md §2.1 container-runtime; upstream paths UNVERIFIED
— empty reference mount).  Wire forms of a flushed batch:

- ``{"type": "groupedBatch", "ops": [...], "idRange"?}``        — plain
- ``{"type": "compressedBatch", "data": <b64 zlib of plain>}``  — compressed
  when the plain encoding exceeds the compression threshold
- ``{"type": "chunk", "id", "index", "total", "data"}``         — N messages
  when the (possibly compressed) encoding exceeds the max message size;
  the batch is processed at the FINAL chunk's sequence number

Both the container runtime and the bulk catch-up service decode through
:func:`decode_contents` / :class:`ChunkReassembler` so the device replay
path folds exactly what clients fold."""

from __future__ import annotations

import base64
import json
import zlib
from typing import Dict, List, Optional

from ..protocol.summary import canonical_json

#: Wire-format version of batch envelopes.  Writers stamp it; readers
#: accept anything at or below (absent = 1, the pre-version format) and
#: refuse newer — a rolled-back replica must fail loudly, not misparse.
BATCH_WIRE_VERSION = 1


def check_batch_version(contents: dict) -> None:
    v = contents.get("v", 1)
    if v > BATCH_WIRE_VERSION:
        raise ValueError(
            f"batch wire version {v} is newer than supported "
            f"{BATCH_WIRE_VERSION}"
        )


def encode_batch(contents: dict, compression_threshold: int,
                 chunk_size: int) -> List[dict]:
    """One logical batch → the message contents list to submit (len 1
    unless chunked)."""
    payload = canonical_json(contents)
    if len(payload) >= compression_threshold:
        contents = {
            "type": "compressedBatch",
            "data": base64.b64encode(
                zlib.compress(payload, level=6)
            ).decode("ascii"),
        }
        payload = canonical_json(contents)
    if len(payload) < chunk_size:
        return [contents]
    # Slice the encoded BYTES (chunk_size bounds payload bytes regardless of
    # character width) and carry each slice base64'd — byte slices need not
    # fall on UTF-8 boundaries.
    pieces = [payload[i:i + chunk_size]
              for i in range(0, len(payload), chunk_size)]
    return [
        {"type": "chunk", "index": i, "total": len(pieces),
         "data": base64.b64encode(piece).decode("ascii")}
        for i, piece in enumerate(pieces)
    ]


def maybe_decompress(contents: dict) -> dict:
    if isinstance(contents, dict) \
            and contents.get("type") == "compressedBatch":
        return json.loads(zlib.decompress(
            base64.b64decode(contents["data"])
        ))
    return contents


class ChunkReassembler:
    """Per-client chunk accumulation (the receive side of OpSplitter)."""

    def __init__(self) -> None:
        self._partial: Dict[str, List[Optional[str]]] = {}

    def feed(self, client_id: str, chunk: dict) -> Optional[dict]:
        """Returns the reassembled (and decompressed) batch contents when
        the final chunk arrives, else None.

        Wire fields are untrusted: a chunk whose index/total is malformed
        or whose total disagrees with the client's partial train resets
        that client's state and is dropped — corrupting reassembly (or
        raising into the container) on a bad peer's message would take
        down good replicas."""
        total, index = chunk.get("total"), chunk.get("index")
        if (not isinstance(total, int) or not isinstance(index, int)
                or isinstance(total, bool) or isinstance(index, bool)
                or total < 1 or not 0 <= index < total):
            self._partial.pop(client_id, None)
            return None
        parts = self._partial.setdefault(client_id, [None] * total)
        if len(parts) != total:
            self._partial.pop(client_id, None)
            return None
        parts[index] = chunk["data"]
        if any(p is None for p in parts):
            return None
        del self._partial[client_id]
        payload = b"".join(base64.b64decode(p) for p in parts)
        return maybe_decompress(json.loads(payload))

    def drop(self, client_id: str) -> None:
        """A departed client's partial chunks can never complete."""
        self._partial.pop(client_id, None)


def decode_stream(messages):
    """Decode a sequenced message stream offline (catch-up service path):
    yields (msg, batch_contents) for every message that completes a logical
    batch — at the final chunk's seq for chunked batches."""
    import dataclasses

    reassembler = ChunkReassembler()
    for msg in messages:
        contents = msg.contents
        if not isinstance(contents, dict):
            continue
        if contents.get("type") == "chunk":
            full = reassembler.feed(msg.client_id, contents)
            if full is not None:
                yield dataclasses.replace(msg, contents=full), full
            continue
        contents = maybe_decompress(contents)
        if contents.get("type") == "groupedBatch":
            check_batch_version(contents)
            yield (msg if contents is msg.contents
                   else dataclasses.replace(msg, contents=contents)), contents
