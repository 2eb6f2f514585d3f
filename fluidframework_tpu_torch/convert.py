"""Carry packed arrays, document inputs and service state across.

Everything is read by attribute name, so any object with the ``MTState``
/ ``MTOps`` (or ``TreeState`` / ``TreeEdits``, or a packed map batch's)
field names holding numpy
arrays converts — the port's own packers' output and the JAX package's
(which is numpy as well) alike — and no import of the JAX package is
needed.  The catch-up service's state (its summary store and op log, the
service's "weights") crosses as plain data: ``load_service_corpus``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .ops.map_kernel import LWWInputs, MapDocInput, lww_inputs
from .ops.matrix_kernel import MatrixDocInput
from .ops.mergetree_kernel import MergeTreeDocInput
from .ops.tree_kernel import TreeDocInput, TreeEdits, TreeState
from .protocol.messages import MessageType, SequencedMessage
from .protocol.summary import SummaryBlob, SummaryTree


def tensors_to(obj, device):
    """An ``MTState`` / ``MTOps`` (or any namedtuple of arrays) as tensors
    on ``device`` with each field's dtype kept: the packer's int32 planes
    and bool ``overflow``, and the narrow upload encodings.  Numpy fields
    are copied there, tensors moved (or kept, when already there).  None
    passes through."""
    if obj is None:
        return None
    return type(obj)(**{
        f: x.to(device) if isinstance(x, torch.Tensor)
        else torch.from_numpy(np.ascontiguousarray(x)).to(device)
        for f, x in obj._asdict().items()})


def _message_from(m) -> SequencedMessage:
    return SequencedMessage(
        seq=m.seq, client_id=m.client_id, client_seq=m.client_seq,
        ref_seq=m.ref_seq, min_seq=m.min_seq,
        type=MessageType(getattr(m.type, "value", m.type)),
        contents=m.contents, timestamp=m.timestamp,
    )


def doc_input_from(obj) -> MergeTreeDocInput:
    """A port ``MergeTreeDocInput`` copied from any object with the same
    attribute names (the JAX package's doc input included), its
    ``SequencedMessage``s rebuilt as the port's."""
    return MergeTreeDocInput(
        doc_id=obj.doc_id,
        ops=[_message_from(m) for m in obj.ops],
        base_records=obj.base_records,
        final_seq=obj.final_seq,
        final_msn=obj.final_msn,
        base_seq=obj.base_seq,
        base_msn=obj.base_msn,
        base_intervals=obj.base_intervals,
        binary_ops=obj.binary_ops,
        binary_clients=obj.binary_clients,
        binary_prop_keys=obj.binary_prop_keys,
        binary_values=obj.binary_values,
        attribution=obj.attribution,
        cache_token=getattr(obj, "cache_token", None),
    )


def summary_tree_from(obj) -> SummaryTree:
    """A port ``SummaryTree`` copied from any summary tree with the same
    shape (``children`` of sub-trees and blobs with ``content`` bytes)."""
    out = SummaryTree()
    for name, child in obj.children.items():
        out.children[name] = summary_tree_from(child) \
            if hasattr(child, "children") else SummaryBlob(child.content)
    return out


def tree_doc_input_from(obj) -> TreeDocInput:
    """A port ``TreeDocInput`` copied from any object with the same
    attribute names (the JAX package's included): messages rebuilt as
    the port's, the base summary as the port's ``SummaryTree``."""
    base = obj.base_summary
    return TreeDocInput(
        doc_id=obj.doc_id,
        ops=[_message_from(m) for m in obj.ops],
        base_summary=None if base is None else summary_tree_from(base),
        final_seq=obj.final_seq,
        final_msn=obj.final_msn,
        attribution=obj.attribution,
        cache_token=getattr(obj, "cache_token", None),
    )


def tree_arrays_from(state, edits):
    """``(TreeState, TreeEdits)`` of numpy planes, dtypes kept, from any
    pair with those field names (the JAX package's ``pack_tree_batch``
    output included)."""
    return (TreeState(**{f: np.asarray(getattr(state, f))
                         for f in TreeState._fields}),
            TreeEdits(**{f: np.asarray(getattr(edits, f))
                         for f in TreeEdits._fields}))


def map_doc_input_from(obj) -> MapDocInput:
    """A port ``MapDocInput`` copied from any object with the same
    attribute names (the JAX package's included)."""
    return MapDocInput(doc_id=obj.doc_id,
                       ops=[_message_from(m) for m in obj.ops],
                       base=None if obj.base is None else dict(obj.base))


def matrix_doc_input_from(obj) -> MatrixDocInput:
    """A port ``MatrixDocInput`` copied from any object with the same
    attribute names (the JAX package's included): messages rebuilt as the
    port's, the base summary as the port's ``SummaryTree``."""
    base = obj.base_summary
    return MatrixDocInput(
        doc_id=obj.doc_id,
        ops=[_message_from(m) for m in obj.ops],
        base_summary=None if base is None else summary_tree_from(base),
        final_seq=obj.final_seq,
        final_msn=obj.final_msn,
    )


def map_batch_from(packed, device) -> LWWInputs:
    """The seven int32 arrays of a packed map batch (the JAX package's
    ``pack_map_batch`` output included) as the port's ``LWWInputs`` of
    tensors on ``device``."""
    return lww_inputs(packed, device)


def summary_tree_from_plain(obj) -> SummaryTree:
    """A port ``SummaryTree`` from nested plain data: ``{name: bytes |
    dict}``, a dict for each sub-tree and bytes for each blob."""
    out = SummaryTree()
    for name, child in obj.items():
        out.children[name] = summary_tree_from_plain(child) \
            if isinstance(child, dict) else SummaryBlob(bytes(child))
    return out


def load_service_corpus(service, docs) -> list:
    """Fill a port ``LocalOrderingService``'s summary store and op log
    from plain data.  ``docs`` maps each document id to a dict with
    ``"summary"`` (nested ``{name: bytes | dict}``, uploaded at
    ``"seq"``) and ``"messages"`` (the sequenced messages as the field
    dicts of ``SequencedMessage.to_dict``, appended in order); either may
    be absent, so a later call appends a grown tail alone.  The op log
    drops messages at or below its head, so re-sending a whole log is a
    no-op for what it already holds.  Returns the document ids."""
    for doc_id, doc in docs.items():
        if doc.get("summary") is not None:
            service.storage.upload(
                doc_id, summary_tree_from_plain(doc["summary"]), doc["seq"])
        for m in doc.get("messages", ()):
            service.oplog.append(
                doc_id, SequencedMessage.from_dict(copy.deepcopy(m)))
    return list(docs)
