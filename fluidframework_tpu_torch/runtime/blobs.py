"""Attachment blobs: out-of-band binary payloads referenced by handle.

Capability-equivalent of the reference's ``BlobManager``
(container-runtime; SURVEY.md §2.1; upstream paths UNVERIFIED — empty
reference mount): large binary values (images, files) are not DDS ops —
they are content-addressed attachments uploaded once and referenced from
DDS values via ``{"fluidBlob": "<sha>"}`` handles.

Deviation from the reference, on purpose: the reference uploads blobs to
storage out-of-band and carries a BlobAttach op; in-proc the blob payload
rides the summary's ``.blobs`` subtree (content-addressed, so incremental
summaries dedup it) and a sequenced attach op replicates the bytes to all
clients immediately.  Unreferenced blobs are dropped at summarize time by
the GC scan."""

from __future__ import annotations

import base64
import hashlib
from typing import Dict, Set

from ..protocol.summary import SummaryTree
from .handles import blob_handle


class BlobManager:
    """Content-addressed attachment store, replicated via sequenced ops."""

    def __init__(self, runtime) -> None:
        self.runtime = runtime
        self._blobs: Dict[str, bytes] = {}

    def create_blob(self, content: bytes) -> dict:
        """Store + replicate; returns the ``{"fluidBlob": sha}`` handle to
        embed in DDS values."""
        sha = hashlib.sha256(content).hexdigest()
        if sha not in self._blobs:
            self._blobs[sha] = content
            self.runtime._submit_blob_attach(sha, content)
        return blob_handle(sha)

    def get_blob(self, handle_or_sha) -> bytes:
        sha = handle_or_sha.get("fluidBlob") \
            if isinstance(handle_or_sha, dict) else handle_or_sha
        return self._blobs[sha]

    def has_blob(self, sha: str) -> bool:
        return sha in self._blobs

    def shas(self):
        return self._blobs.keys()

    def process_attach(self, sha: str, content_b64: str) -> None:
        self._blobs.setdefault(sha, base64.b64decode(content_b64))

    # -- summary ---------------------------------------------------------------

    def summarize(self, surviving: Set[str]) -> SummaryTree:
        """``surviving`` comes from the GC: referenced blobs plus
        unreferenced ones still inside the sweep grace window (a late
        handle write in the post-summary tail can still revive them)."""
        tree = SummaryTree()
        for sha in sorted(self._blobs):
            if sha in surviving:
                tree.add_blob(sha, self._blobs[sha])
        return tree

    def load(self, tree: SummaryTree) -> None:
        self._blobs = {
            sha: node.content for sha, node in tree.children.items()
        }
