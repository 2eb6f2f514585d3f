"""SharedMatrix catch-up replay in PyTorch.

Counterpart of ``fluidframework_tpu/ops/matrix_kernel.py``.  The
matrix's two permutation vectors are merge-trees over handle runs, and a
run of ``n`` sequentially-allocated handles is exactly a ``(tstart=base,
tlen=n)`` span, so both axis folds are the merge-tree fold.  The
matrix-specific piece is **cell resolution**: a ``setCell`` op's
positions are resolved to handles *in the op's view at its fold
position*, as a row of kind ``K_RESOLVE`` that mutates nothing (the fold
skips kinds outside 1–4) and emits

    handle(pos) = tstart[slot] + (pos - cum[slot])   where pos lands in slot

or -1 (every other row, and a position in no visible slot).  Both axis
streams of every document pack into one batch (doc d's rows at 2d, its
columns at 2d + 1).  The cell store stays on the host: the resolved
(row, col) handles come back and ``_fold_cells`` folds the per-cell LWW /
FWW chains.

The host half (``pack_matrix_batch``, ``_axis_records``, ``_fold_cells``,
``summary_from_matrix_state``, the routing) is a copy of the reference's.
The device half:

- ``replay_scan_resolving`` — the plain PyTorch fold with resolution, on
  the port's ``_visible_len`` / ``_excl_cumsum`` / ``_apply_op``: for each
  row, resolve on the carry, then apply the row (``cold=True``: from the
  pack's fill state, ``matrix_fill_state``);
- ``ops.matrix_fold_cuda.fold_resolving`` — the hand-written kernel
  (CUDA tensors) or the plain version (CPU tensors);
- ``replay_matrix_batch`` — the entry point: a cold batch (no base
  summary; ``meta["cold"]``) uploads no state, and only the planes the
  summaries read come back, up to the batch's largest ``n``.

Summary extraction renumbers handles canonically, exactly like the
oracle, so the bytes match ``SharedMatrix.summarize()``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..protocol.messages import MessageType, SequencedMessage
from ..protocol.summary import SummaryTree, canonical_json
from .interning import Interner, next_bucket
from .mergetree_kernel import (
    K_INSERT,
    K_REMOVE,
    MTOps,
    MTState,
    NOT_REMOVED,
    OP_FIELDS,
    PROP_NOT_TOUCHED,
    _TSTART,
    _apply_op,
    _excl_cumsum,
    _first,
    _stack_state,
    _unstack_state,
    _visible_len,
    resolve_device,
)

K_RESOLVE = 5  # pure read: resolve position -> handle (no state change)
# (4 is K_OBLITERATE in the shared op-kind space; permutation streams never
# carry it, but the shared _apply_op must not mistake a resolve for one.)


def resolve_handle(st, n, slot, op) -> torch.Tensor:
    """The (D, 1) handle each document's row resolves to on the stacked
    state ``st`` (the reference's ``_resolve_handle``): the first slot
    with ``cum <= a < cum + v`` in the row's view, ``tstart + a - cum``
    there; -1 where no slot holds ``a`` or the row is not a resolve."""
    S = st.shape[2]
    a = op["a"]
    v = _visible_len(st, n, slot, op["ref_seq"], op["client"])
    cum = _excl_cumsum(v)
    idx = _first((cum <= a) & (a < cum + v), slot, S)
    at = idx.clamp(max=S - 1)
    handle = torch.gather(st[:, _TSTART], 1, at) + a \
        - torch.gather(cum, 1, at)
    return torch.where((idx < S) & (op["kind"] == K_RESOLVE), handle, -1)


#: the value ``pack_matrix_batch`` fills each slot plane with (props: 0)
MATRIX_PLANE_FILL = {
    "tstart": 0, "tlen": 0, "ins_seq": 0, "ins_client": -1,
    "rem_seq": int(NOT_REMOVED), "rem_client": -1,
    "rem2_seq": int(NOT_REMOVED), "rem2_client": -1,
    "ob1_seq": int(NOT_REMOVED), "ob1_client": -1,
    "ob2_seq": int(NOT_REMOVED), "ob2_client": -1,
}
#: the obliterate planes' fill: no matrix op stamps them
MATRIX_OB_FILL = {f: v for f, v in MATRIX_PLANE_FILL.items()
                  if f.startswith("ob")}


def matrix_fill_state(D: int, S: int, device) -> MTState:
    """The state ``pack_matrix_batch`` packs for ``D`` streams of ``S``
    slots when no document has a base summary: every plane its fill,
    ``props`` 0, ``n`` 0, no overflow."""
    planes = {f: torch.full((D, S), v, dtype=torch.int32, device=device)
              for f, v in MATRIX_PLANE_FILL.items()}
    return MTState(**planes,
                   props=torch.zeros((D, S, 1), dtype=torch.int32,
                                     device=device),
                   n=torch.zeros((D,), dtype=torch.int32, device=device),
                   overflow=torch.zeros((D,), dtype=torch.bool,
                                        device=device))


def replay_scan_resolving(state: MTState, ops: MTOps, cold: bool = False,
                          S: Optional[int] = None):
    """The plain axis fold that also emits each row's resolved handle:
    ``(final MTState, resolved [D, T] int32)``, on whatever device the
    tensors lie.  Counterpart of the reference's ``replay_scan_resolving``
    under ``vmap`` (``_replay_matrix_batch``).  ``cold``: fold from
    ``matrix_fill_state`` of ``S`` slots (``state``'s when ``S`` is None;
    its values unread)."""
    if cold:
        S = state.tstart.shape[1] if S is None else S
        state = matrix_fill_state(ops.kind.shape[0], S, ops.kind.device)
    st = _stack_state(state)
    D, _P, S = st.shape
    n = state.n.to(torch.int32).reshape(D, 1)
    overflow = state.overflow.to(torch.bool).reshape(D, 1)
    slot = torch.arange(S, device=st.device)[None, :]
    fields = {f: getattr(ops, f).to(torch.int32) for f in OP_FIELDS}
    pvals = ops.pvals.to(torch.int32)
    T = ops.kind.shape[1]
    resolved = torch.empty((D, T), dtype=torch.int32, device=st.device)
    for t in range(T):
        op = {f: x[:, t:t + 1] for f, x in fields.items()}
        op["pvals"] = pvals[:, t]
        resolved[:, t:t + 1] = resolve_handle(st, n, slot, op)
        st, n, overflow = _apply_op(st, n, overflow, slot, op)
    return _unstack_state(st, n.reshape(D), overflow.reshape(D)), resolved


@dataclass
class MatrixDocInput:
    """One matrix document's catch-up work item."""

    doc_id: str
    ops: Sequence[SequencedMessage]  # matrix op contents, ascending seq
    base_summary: Optional[SummaryTree] = None
    final_seq: int = 0
    final_msn: int = 0


def known_matrix_fallback(doc: MatrixDocInput) -> bool:
    """Pre-pack oracle-fallback predicate: >1 overlap remover on a base
    permutation record (the device tracks exactly two removers and the base
    format carries no overlap seqs — same rule as the merge-tree kernel)."""
    if doc.base_summary is None:
        return False
    body = json.loads(doc.base_summary.blob_bytes("body"))
    return any(
        len(rec.get("ro", [])) > 1
        for axis in ("rows", "cols")
        for rec in body[axis]
    )


class _MatrixDocPack:
    """Per-document host bookkeeping during packing."""

    def __init__(self) -> None:
        self.clients = Interner()
        # setCell metadata in seq order: (seq, ref_seq, client_idx, val_id,
        # row_slot, col_slot) where *_slot index the axis op streams.
        self.cells: List[Tuple[int, int, int, int, int, int]] = []
        self.base_cells: List[list] = []  # [r, c, val_id, seq, client_idx]
        self.fww_from_seq: Optional[int] = None  # seq of the setPolicy switch
        self.base_policy = "lww"
        self.base_seq = 0

    def client_idx(self, client_id) -> int:
        if client_id is None:
            return -1
        return self.clients.intern(client_id)


def pack_matrix_batch(docs: Sequence[MatrixDocInput]):
    """Pack documents into one [2D, ...] axis-stream batch + host metadata
    (numpy ``MTState`` / ``MTOps``, as the reference's)."""
    values = Interner()
    packs = [_MatrixDocPack() for _ in docs]

    # Per-stream op/base-record counts decide shared bucket sizes.
    parsed: List[Tuple[dict, dict]] = []  # (header, body) per doc
    for doc in docs:
        if doc.base_summary is not None:
            header = json.loads(doc.base_summary.blob_bytes("header"))
            body = json.loads(doc.base_summary.blob_bytes("body"))
        else:
            header, body = {"seq": 0, "policy": "lww"}, {
                "rows": [], "cols": [], "cells": [],
            }
        parsed.append((header, body))

    def stream_ops(doc: MatrixDocInput, axis: str) -> int:
        n = 0
        for msg in doc.ops:
            kind = msg.contents["kind"]
            if kind == "setCell" or axis in kind.lower():
                n += 1
        return n

    T = next_bucket(
        max(
            [stream_ops(d, ax) for d in docs for ax in ("row", "col")],
            default=1,
        ),
        floor=16,
    )
    S = next_bucket(
        max(
            (
                len(body[axis]) + 2 * stream_ops(doc, ax)
                for doc, (_h, body) in zip(docs, parsed)
                for axis, ax in (("rows", "row"), ("cols", "col"))
            ),
            default=1,
        ),
        floor=32,
    )

    D2 = 2 * len(docs)
    st = {
        "tstart": np.zeros((D2, S), np.int32),
        "tlen": np.zeros((D2, S), np.int32),
        "ins_seq": np.zeros((D2, S), np.int32),
        "ins_client": np.full((D2, S), -1, np.int32),
        "rem_seq": np.full((D2, S), NOT_REMOVED, np.int32),
        "rem_client": np.full((D2, S), -1, np.int32),
        "rem2_seq": np.full((D2, S), NOT_REMOVED, np.int32),
        "rem2_client": np.full((D2, S), -1, np.int32),
        "ob1_seq": np.full((D2, S), NOT_REMOVED, np.int32),
        "ob1_client": np.full((D2, S), -1, np.int32),
        "ob2_seq": np.full((D2, S), NOT_REMOVED, np.int32),
        "ob2_client": np.full((D2, S), -1, np.int32),
        "props": np.zeros((D2, S, 1), np.int32),  # unused by matrix
        "n": np.zeros((D2,), np.int32),
        "overflow": np.zeros((D2,), np.bool_),
    }
    op = {
        "kind": np.zeros((D2, T), np.int32),
        "seq": np.zeros((D2, T), np.int32),
        "client": np.zeros((D2, T), np.int32),
        "ref_seq": np.zeros((D2, T), np.int32),
        "min_seq": np.zeros((D2, T), np.int32),
        "a": np.zeros((D2, T), np.int32),
        "b": np.zeros((D2, T), np.int32),
        "tstart": np.zeros((D2, T), np.int32),
        "tlen": np.zeros((D2, T), np.int32),
        "pvals": np.full((D2, T, 1), PROP_NOT_TOUCHED, np.int32),
    }

    for d, (doc, (header, body)) in enumerate(zip(docs, parsed)):
        pack = packs[d]
        pack.base_seq = header.get("seq", 0)
        pack.base_policy = header.get("policy", "lww")
        if pack.base_policy == "fww":
            pack.fww_from_seq = 0
        for val in body.get("cells", []):
            r, c, value, seq, client = val
            pack.base_cells.append(
                [r, c, values.intern(value), seq, pack.client_idx(client)]
            )

        next_handle = {"row": 0, "col": 0}
        for axis, ax, s_idx in (("rows", "row", 2 * d), ("cols", "col", 2 * d + 1)):
            for s, rec in enumerate(body[axis]):
                st["tstart"][s_idx, s] = next_handle[ax]
                st["tlen"][s_idx, s] = rec["n"]
                next_handle[ax] += rec["n"]
                st["ins_seq"][s_idx, s] = rec["s"]
                st["ins_client"][s_idx, s] = pack.client_idx(rec["c"])
                if "rs" in rec:
                    st["rem_seq"][s_idx, s] = rec["rs"]
                    st["rem_client"][s_idx, s] = pack.client_idx(rec.get("rc"))
                ro = rec.get("ro", [])
                if ro:
                    # Any seq below the base seq is faithful (sequenced
                    # before every tail op); >1 removers -> pre-pack fallback.
                    st["rem2_seq"][s_idx, s] = pack.base_seq
                    st["rem2_client"][s_idx, s] = pack.client_idx(ro[0])
            st["n"][s_idx] = len(body[axis])

        t = {"row": -1, "col": -1}
        for msg in doc.ops:
            if msg.type is not MessageType.OP:
                continue
            contents = msg.contents
            kind = contents["kind"]
            client = pack.client_idx(msg.client_id)
            if kind == "setPolicy":
                if pack.fww_from_seq is None:
                    pack.fww_from_seq = msg.seq
                continue
            if kind == "setCell":
                slots = {}
                for ax, pos_key in (("row", "row"), ("col", "col")):
                    t[ax] += 1
                    s_idx = 2 * d + (0 if ax == "row" else 1)
                    tt = t[ax]
                    op["kind"][s_idx, tt] = K_RESOLVE
                    op["seq"][s_idx, tt] = msg.seq
                    op["client"][s_idx, tt] = client
                    op["ref_seq"][s_idx, tt] = msg.ref_seq
                    op["a"][s_idx, tt] = contents[pos_key]
                    slots[ax] = tt
                pack.cells.append(
                    (
                        msg.seq,
                        msg.ref_seq,
                        client,
                        values.intern(contents["value"]),
                        slots["row"],
                        slots["col"],
                    )
                )
                continue
            ax = "row" if "Row" in kind else "col"
            s_idx = 2 * d + (0 if ax == "row" else 1)
            t[ax] += 1
            tt = t[ax]
            op["seq"][s_idx, tt] = msg.seq
            op["client"][s_idx, tt] = client
            op["ref_seq"][s_idx, tt] = msg.ref_seq
            if kind.startswith("insert"):
                op["kind"][s_idx, tt] = K_INSERT
                op["a"][s_idx, tt] = contents["pos"]
                op["tstart"][s_idx, tt] = next_handle[ax]
                op["tlen"][s_idx, tt] = contents["count"]
                next_handle[ax] += contents["count"]
            elif kind.startswith("remove"):
                op["kind"][s_idx, tt] = K_REMOVE
                op["a"][s_idx, tt] = contents["start"]
                op["b"][s_idx, tt] = contents["end"]
            else:
                raise ValueError(f"unknown matrix op kind {kind!r}")

    # cold: no document has a base summary, so every plane is its fill
    # and n = 0 (the device fold then reads no state)
    meta = {"packs": packs, "values": values, "docs": docs,
            "cold": all(doc.base_summary is None for doc in docs)}
    return MTState(**{k: v for k, v in st.items()}), MTOps(**op), meta


def _axis_records(
    state_np: dict, s_idx: int, msn: int, clients: Interner
) -> Tuple[List[dict], Dict[int, int]]:
    """Final device axis state → canonical records + handle→canonical map
    (mirrors PermutationVector.canonical_records)."""
    records: List[dict] = []
    handle_map: Dict[int, int] = {}
    n = int(state_np["n"][s_idx])
    for s in range(n):
        rs = int(state_np["rem_seq"][s_idx, s])
        removed = rs != NOT_REMOVED
        if removed and rs <= msn:
            continue
        base = int(state_np["tstart"][s_idx, s])
        count = int(state_np["tlen"][s_idx, s])
        for h in range(base, base + count):
            handle_map[h] = len(handle_map)
        ins_seq = int(state_np["ins_seq"][s_idx, s])
        if ins_seq <= msn:
            seq_out, client_out = 0, None
        else:
            seq_out = ins_seq
            client_out = clients.lookup(int(state_np["ins_client"][s_idx, s]))
        rec: dict = {"n": count, "s": seq_out, "c": client_out}
        if removed:
            rec["rs"] = rs
            rc = int(state_np["rem_client"][s_idx, s])
            rec["rc"] = clients.lookup(rc) if rc >= 0 else None
        rc2 = int(state_np["rem2_client"][s_idx, s])
        if rc2 >= 0:
            rec["ro"] = [clients.lookup(rc2)]
        if records:
            prev = records[-1]
            if (
                prev["s"] == rec["s"]
                and prev["c"] == rec["c"]
                and prev.get("rs") == rec.get("rs")
                and prev.get("rc") == rec.get("rc")
                and prev.get("ro") == rec.get("ro")
            ):
                prev["n"] += rec["n"]
                continue
        records.append(rec)
    return records, handle_map


def _fold_cells(pack: _MatrixDocPack, resolved_rh, resolved_ch):
    """Host cell-winner fold: tiny per-cell chains, LWW before the policy
    switch seq and FWW after (acceptance depends on the previous accepted
    write, so the chain is sequential — and short)."""
    store: Dict[Tuple[int, int], Tuple[int, int, int]] = {}  # (val, seq, cl)
    for r, c, val, seq, client in pack.base_cells:
        store[(r, c)] = (val, seq, client)
    fww_from = pack.fww_from_seq
    for seq, ref_seq, client, val, row_slot, col_slot in pack.cells:
        rh = int(resolved_rh[row_slot])
        ch = int(resolved_ch[col_slot])
        if rh < 0 or ch < 0:
            continue  # position beyond the op's view: deterministic no-op
        if fww_from is not None and seq > fww_from:
            entry = store.get((rh, ch))
            if entry is not None and entry[1] > ref_seq and entry[2] != client:
                continue  # first sequenced writer wins
        store[(rh, ch)] = (val, seq, client)
    return store


def oracle_matrix_fallback(doc: MatrixDocInput) -> SummaryTree:
    """Full oracle replay — exactness escape hatch (same role as the
    merge-tree kernel's)."""
    from ..dds.matrix import SharedMatrix

    replica = SharedMatrix(doc.doc_id)
    if doc.base_summary is not None:
        replica.load(doc.base_summary)
    for msg in doc.ops:
        replica.process(msg, local=False)
    replica.advance(doc.final_seq, doc.final_msn)
    return replica.summarize()


def summary_from_matrix_state(meta, state_np, resolved_np, d: int,
                              stats: Optional[dict] = None) -> SummaryTree:
    """``stats`` counts this doc as device/fallback WHERE the routing
    decision is made, so the counters can never drift from the actual
    serving path."""
    doc: MatrixDocInput = meta["docs"][d]
    pack: _MatrixDocPack = meta["packs"][d]
    values: Interner = meta["values"]
    if bool(state_np["overflow"][2 * d]) or bool(state_np["overflow"][2 * d + 1]):
        if stats is not None:
            stats["fallback_docs"] = stats.get("fallback_docs", 0) + 1
        return oracle_matrix_fallback(doc)
    if stats is not None:
        stats["device_docs"] = stats.get("device_docs", 0) + 1
    msn = doc.final_msn
    row_records, row_map = _axis_records(state_np, 2 * d, msn, pack.clients)
    col_records, col_map = _axis_records(state_np, 2 * d + 1, msn, pack.clients)
    store = _fold_cells(pack, resolved_np[2 * d], resolved_np[2 * d + 1])
    cells = []
    for (rh, ch), (val, seq, client) in store.items():
        if rh not in row_map or ch not in col_map:
            continue
        if seq <= msn:
            seq, client_out = 0, None
        else:
            client_out = pack.clients.lookup(client) if client >= 0 else None
        cells.append(
            [row_map[rh], col_map[ch], values.lookup(val), seq, client_out]
        )
    cells.sort(key=lambda e: (e[0], e[1]))

    def visible(s_idx: int) -> int:
        n = int(state_np["n"][s_idx])
        return sum(
            int(state_np["tlen"][s_idx, s])
            for s in range(n)
            if int(state_np["rem_seq"][s_idx, s]) == NOT_REMOVED
        )

    policy = "fww" if pack.fww_from_seq is not None else "lww"
    header = {
        "seq": doc.final_seq,
        "minSeq": msn,
        "rows": visible(2 * d),
        "cols": visible(2 * d + 1),
        "policy": policy,
    }
    body = {"rows": row_records, "cols": col_records, "cells": cells}
    tree = SummaryTree()
    tree.add_blob("header", canonical_json(header))
    tree.add_blob("body", canonical_json(body))
    return tree


#: the slot planes summary extraction reads (with ``n`` and ``overflow``)
SUMMARY_FIELDS = ("tstart", "tlen", "ins_seq", "ins_client", "rem_seq",
                  "rem_client", "rem2_client")


def upload_matrix_batch(state: MTState, ops: MTOps, meta: dict, device):
    """A packed batch on ``device`` for the fold: ``(state, ops, h2d
    bytes)``, ``state`` None for a cold batch (the fold builds the fill
    itself)."""
    from ..convert import tensors_to

    ops_d = tensors_to(ops, device)
    moved = sum(x.numel() * x.element_size() for x in ops_d)
    if meta["cold"]:
        return None, ops_d, moved
    state_d = tensors_to(state, device)
    return state_d, ops_d, moved + sum(x.numel() * x.element_size()
                                       for x in state_d)


def download_matrix_fold(final: MTState, resolved, violations):
    """What summary extraction reads of a fold, on the host: ``(state
    arrays, resolved, d2h bytes)`` with ``n``, ``overflow`` and the
    ``SUMMARY_FIELDS`` planes up to the batch's largest ``n`` (the slots
    past it are never read).  Raises ``ValueError`` when the fold counted
    a violated fact."""
    from .matrix_fold_cuda import check_facts

    viol = violations.cpu().numpy()
    check_facts(viol)
    n = final.n.cpu().numpy()
    state_np = {"n": n, "overflow": final.overflow.cpu().numpy()}
    width = min(int(n.max(initial=0)), final.tstart.shape[1])
    for f in SUMMARY_FIELDS:
        state_np[f] = getattr(final, f)[:, :width].cpu().numpy()
    resolved_np = resolved.cpu().numpy()
    moved = sum(x.nbytes for x in state_np.values()) + resolved_np.nbytes \
        + viol.nbytes
    return state_np, resolved_np, moved


def replay_matrix_batch(docs: Sequence[MatrixDocInput],
                        stats: Optional[dict] = None,
                        device="cuda",
                        stage: Optional[dict] = None) -> List[SummaryTree]:
    """Full pipeline: pack → dual-axis fold with resolution on ``device``
    → host cell fold → canonical summaries.  Byte-identical to
    ``SharedMatrix.summarize()``.  ``stats`` accumulates ``device_docs`` /
    ``fallback_docs`` (pre-pack routing + per-axis overflow fallbacks);
    ``stage`` accumulates the fold's ``h2d_bytes`` / ``d2h_bytes``.  On a
    CUDA device the fold is the hand-written kernel
    (``matrix_fold_cuda.fold_resolving``); on ``"cpu"`` its plain
    version."""
    from .batching import partition_replay
    from .matrix_fold_cuda import fold_resolving

    dev = resolve_device(device)

    def fold_batch(batch):
        state, ops, meta = pack_matrix_batch(batch)
        state_d, ops_d, h2d = upload_matrix_batch(state, ops, meta, dev)
        final, resolved, violations = fold_resolving(
            state_d, ops_d, cold=meta["cold"], S=state.tstart.shape[1])
        state_np, resolved_np, d2h = download_matrix_fold(final, resolved,
                                                          violations)
        if stage is not None:
            stage["h2d_bytes"] = stage.get("h2d_bytes", 0) + h2d
            stage["d2h_bytes"] = stage.get("d2h_bytes", 0) + d2h
        return [
            summary_from_matrix_state(meta, state_np, resolved_np, d,
                                      stats=stats)
            for d in range(len(batch))
        ]

    return partition_replay(
        docs, known_matrix_fallback, oracle_matrix_fallback, fold_batch,
        stats=stats,
    )
