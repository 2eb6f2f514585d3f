"""Carry packed arrays and document inputs across.

Everything is read by attribute name, so any object with the ``MTState``
/ ``MTOps`` field names holding numpy arrays converts — the port's own
``pack_mergetree_batch`` output and the JAX package's (which is numpy as
well) alike — and no import of the JAX package is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.mergetree_kernel import MergeTreeDocInput
from .protocol.messages import MessageType, SequencedMessage


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
