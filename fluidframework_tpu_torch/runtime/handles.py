"""Fluid-handle equivalents: serializable references between stored values
and datastores/channels/blobs.

Capability-equivalent of the reference's ``IFluidHandle`` + handle
serialization in shared-object-base (SURVEY.md §2.1; upstream paths
UNVERIFIED — empty reference mount).  A handle is a plain JSON token so it
survives any channel's value encoding:

    {"fluidHandle": "/<datastore>/<channel>"}     — a channel reference
    {"fluidBlob": "<sha256>"}                     — an attachment blob

The GC walks these tokens through summary bytes (format-agnostic: any DDS
that stores values as canonical JSON is scannable without per-DDS code).
"""

from __future__ import annotations

import re
from typing import List, Set

HANDLE_KEY = "fluidHandle"
BLOB_KEY = "fluidBlob"

_HANDLE_RE = re.compile(rb'"fluidHandle":"(/[^"]+)"')
_BLOB_RE = re.compile(rb'"fluidBlob":"([0-9a-f]{64})"')


def channel_handle(ds_id: str, channel_id: str) -> dict:
    return {HANDLE_KEY: f"/{ds_id}/{channel_id}"}


def datastore_handle(ds_id: str) -> dict:
    return {HANDLE_KEY: f"/{ds_id}"}


def blob_handle(sha: str) -> dict:
    return {BLOB_KEY: sha}


def is_handle(value) -> bool:
    return isinstance(value, dict) and (HANDLE_KEY in value
                                        or BLOB_KEY in value)


def scan_handles(blob: bytes) -> List[str]:
    """All datastore/channel handle paths referenced in serialized bytes."""
    return [m.decode("utf-8") for m in _HANDLE_RE.findall(blob)]


def scan_blob_refs(blob: bytes) -> Set[str]:
    """All attachment-blob shas referenced in serialized bytes."""
    return {m.decode("ascii") for m in _BLOB_RE.findall(blob)}
