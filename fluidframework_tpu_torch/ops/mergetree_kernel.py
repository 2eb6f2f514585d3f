"""Merge-tree catch-up replay in PyTorch — the port's main path.

Counterpart of ``fluidframework_tpu/ops/mergetree_kernel.py``.  The host
half (packing, oracle routing, summary extraction) is a copy of the
reference's; the device half is rewritten in torch:

- ``fold_reference`` — the plain PyTorch fold: the full semantics of the
  reference's ``_apply_op`` / ``_split_at`` / ``_visible_len`` over
  ``[D, S]`` planes with ``(D, 1)`` per-op columns, one Python step per
  op row.  It is the CPU path and the card's yardstick for the kernel;
- ``ops.fold_cuda.fold`` / ``fold_export`` — the hand-written Hopper
  kernel (CUDA tensors) or the plain versions (CPU tensors);
- the transfer encodings, as the reference has them: the narrow uploads
  (``narrow_ops_for_upload`` / ``narrow_state_for_upload``, host numpy)
  and their device decode (``_widen_ops`` / ``_widen_state``), the export
  layouts (``_export_state``: int32, int16, int8 pairs, with obliterate /
  overlap / props rows elided by ``_export_flags``) and the state digest
  (``_doc_digests``), each in plain PyTorch; ``export_reference`` chains
  them around ``fold_reference``, the plain version of the kernel's
  fold+export build;
- the host side of the export: ``widen_export`` / ``widen_export_native``
  back to the canonical int32 layout, then ``summaries_from_export``;
- ``replay_export`` / ``replay_mergetree_batch`` — the entry points
  (``ops.pipeline.pipelined_mergetree_replay`` is the chunked one).

The state layout is the reference's at every public function: ``MTState``
holds twelve ``[D, S]`` int32 planes, ``props [D, S, K]``, ``n [D]`` int32
and ``overflow [D]`` bool; ``MTOps`` holds nine ``[D, T]`` int32 fields
and ``pvals [D, T, K]``.  Slots ``[0, n)`` are the document's segments in
sequence order; slots beyond ``n`` hold shift leftovers no consumer reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..protocol.messages import SequencedMessage
from ..protocol.summary import SummaryTree, canonical_json
from .interning import Interner, TextArena, next_bucket, next_bucket_fine
from .native_pack import count_stream

NOT_REMOVED = np.int32(np.iinfo(np.int32).max)
# Property-column sentinels (values are interned ids >= 0).
PROP_ABSENT = -1      # key not set on the segment
PROP_NOT_TOUCHED = -2  # annotate op does not touch this key

K_NOOP, K_INSERT, K_REMOVE, K_ANNOTATE, K_OBLITERATE = 0, 1, 2, 3, 4

_NR = int(NOT_REMOVED)
#: the strict value bound behind the pack-time ``i16_ok`` fact, and the
#: sentinel NOT_REMOVED becomes in int16 transfer encodings
I16_NOT_REMOVED = np.int16(np.iinfo(np.int16).max)
I16_LIMIT = int(np.iinfo(np.int16).max) - 1
#: int8 pair packing (``i8_ok``): every exported value other than tstart and
#: misc fits a signed byte; NOT_REMOVED rides as 127
I8_NOT_REMOVED = np.int32(127)
I8_LIMIT = 126


class MTState(NamedTuple):
    """Per-document segment pool, in sequence order (slots [0, n))."""

    tstart: Any       # [D, S] arena offset
    tlen: Any         # [D, S] span length (chars)
    ins_seq: Any      # [D, S]
    ins_client: Any   # [D, S] per-doc client idx; -1 = universal epoch
    rem_seq: Any      # [D, S] NOT_REMOVED if alive
    rem_client: Any   # [D, S] -1 if alive
    rem2_seq: Any     # [D, S] second (overlap) remover seq / NOT_REMOVED
    rem2_client: Any  # [D, S] second remover client / -1
    ob1_seq: Any      # [D, S] first obliterate stamp seq / NOT_REMOVED
    ob1_client: Any   # [D, S] first stamp client / -1
    ob2_seq: Any      # [D, S] second obliterate stamp seq / NOT_REMOVED
    ob2_client: Any   # [D, S] second stamp client / -1
    props: Any        # [D, S, K] interned value ids / PROP_ABSENT
    n: Any            # [D] live slot count
    overflow: Any     # [D] bool: >2 removers (or stamps) hit one segment


class MTOps(NamedTuple):
    """Packed op stream, one row per sequenced op."""

    kind: Any     # [D, T]
    seq: Any      # [D, T]
    client: Any   # [D, T] per-doc client idx
    ref_seq: Any  # [D, T]
    min_seq: Any  # [D, T] stamped MSN (drives expiry parity w/ zamboni)
    a: Any        # [D, T] pos (insert) / start (remove, annotate)
    b: Any        # [D, T] end (remove, annotate)
    tstart: Any   # [D, T] arena offset of inserted text
    tlen: Any     # [D, T]
    pvals: Any    # [D, T, K] per-key values / PROP_NOT_TOUCHED


#: the twelve slot planes, in export row order
EXPORT_SLOT_FIELDS = (
    "tstart", "tlen", "ins_seq", "ins_client",
    "rem_seq", "rem_client", "rem2_seq", "rem2_client",
    "ob1_seq", "ob1_client", "ob2_seq", "ob2_client",
)
#: the slot fields with no obliterate content — the export layout when a
#: chunk provably carries no obliterates (``meta["ob_rows"]`` False)
NON_OB_SLOT_FIELDS = EXPORT_SLOT_FIELDS[:8]
#: the obliterate rows elided from such exports, with their sentinel fills
OB_SLOT_FIELDS = EXPORT_SLOT_FIELDS[8:]
#: the overlap-remover rows, elided (``meta["ov_rows"]`` False) when every
#: op rides a fully sequential view and no base record carries "ro"
OV_SLOT_FIELDS = ("rem2_seq", "rem2_client")
#: rows holding seqs with the NOT_REMOVED sentinel (narrow remap set)
SENTINEL_SEQ_FIELDS = ("rem_seq", "rem2_seq", "ob1_seq", "ob2_seq")
#: the nine scalar op fields (``pvals`` rides beside them)
OP_FIELDS = MTOps._fields[:9]

# Plane indices of the stacked [D, 12 + K, S] working state.
(_TSTART, _TLEN, _INS_SEQ, _INS_CLIENT, _REM_SEQ, _REM_CLIENT, _REM2_SEQ,
 _REM2_CLIENT, _OB1_SEQ, _OB1_CLIENT, _OB2_SEQ, _OB2_CLIENT) = range(12)
_PROPS0 = 12


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` (the default of every
    entry point) must exist: there is no quiet fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain fold on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Device half: the plain PyTorch fold
# ---------------------------------------------------------------------------


def _stack_state(state: MTState) -> torch.Tensor:
    planes = [getattr(state, f) for f in EXPORT_SLOT_FIELDS]
    planes += list(state.props.permute(2, 0, 1))
    return torch.stack(planes, dim=1).to(torch.int32).contiguous()


def _unstack_state(st: torch.Tensor, n: torch.Tensor,
                   overflow: torch.Tensor) -> MTState:
    planes = {f: st[:, i].contiguous()
              for i, f in enumerate(EXPORT_SLOT_FIELDS)}
    return MTState(**planes,
                   props=st[:, _PROPS0:].permute(0, 2, 1).contiguous(),
                   n=n, overflow=overflow)


def _visible_len(st, n, slot, ref_seq, client):
    """Visible length of every slot in the op's (ref_seq, client) view;
    ``n``/``ref_seq``/``client`` are (D, 1) columns."""
    active = slot < n
    ins_vis = (st[:, _INS_SEQ] <= ref_seq) | (st[:, _INS_CLIENT] == client)
    removed = st[:, _REM_SEQ] != _NR
    rem_vis = (
        (st[:, _REM_SEQ] <= ref_seq)
        | (st[:, _REM_CLIENT] == client)
        | (st[:, _REM2_CLIENT] == client)
        # An obliterate stamp makes its author involved in the removal
        # even when another client's remove won it (the oracle's
        # merge_tree._removed_in_view rule).
        | (removed & (st[:, _OB1_CLIENT] == client))
        | (removed & (st[:, _OB2_CLIENT] == client))
    )
    return torch.where(active & ins_vis & ~rem_vis, st[:, _TLEN], 0)


def _excl_cumsum(v: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(v, dim=1, dtype=torch.int32) - v


def _first(mask: torch.Tensor, slot: torch.Tensor, S: int) -> torch.Tensor:
    """(D, 1) index of the first set slot per row, ``S`` when none."""
    return torch.where(mask, slot, S).amin(dim=1, keepdim=True)


def _shift_right_from(st: torch.Tensor, slot: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """moved[s] = st[s] for s <= idx else st[s - 1], on every plane."""
    prev = torch.cat([st[:, :, :1], st[:, :, :-1]], dim=2)
    return torch.where((slot <= idx)[:, None, :], st, prev)


def _split_at(st, n, slot, char_pos, ref_seq, client, enable):
    """Split the segment ``char_pos`` falls strictly inside of (in the op's
    view), shifting the pool right by one; inert where ``enable`` is false
    or the position lands on a boundary."""
    S = st.shape[2]
    v = _visible_len(st, n, slot, ref_seq, client)
    cum = _excl_cumsum(v)
    inside = (cum < char_pos) & (char_pos < cum + v)
    idx = _first(inside, slot, S)
    do = enable & (idx < S)
    idx_c = idx.clamp(max=S - 1)
    off = char_pos - torch.gather(cum, 1, idx_c)
    moved = _shift_right_from(st, slot, idx)
    tlen = moved[:, _TLEN]
    is_left = slot == idx
    is_right = slot == idx + 1
    moved[:, _TLEN] = torch.where(
        is_left, off, torch.where(is_right, tlen - off, tlen))
    moved[:, _TSTART] = torch.where(
        is_right, moved[:, _TSTART] + off, moved[:, _TSTART])
    st = torch.where(do[:, :, None], moved, st)
    return st, torch.where(do, n + 1, n)


def _apply_op(st, n, overflow, slot, op):
    """One sequenced op for every document at once.  ``st`` is the
    stacked ``[D, 12 + K, S]`` state, ``n``/``overflow`` are (D, 1), and
    ``op`` maps each op field to its (D, 1) column (``pvals`` to (D, K))."""
    S = st.shape[2]
    ref_seq, client, seq = op["ref_seq"], op["client"], op["seq"]
    a, b = op["a"], op["b"]
    kind = op["kind"]
    is_ins = kind == K_INSERT
    is_rem = kind == K_REMOVE
    is_ann = kind == K_ANNOTATE
    is_obl = kind == K_OBLITERATE
    is_rangey = is_rem | is_ann | is_obl

    # Boundary splits (shared by all op kinds).
    st, n = _split_at(st, n, slot, a, ref_seq, client, is_ins | is_rangey)
    st, n = _split_at(st, n, slot, b, ref_seq, client, is_rangey)

    v = _visible_len(st, n, slot, ref_seq, client)
    cum = _excl_cumsum(v)
    active = slot < n
    # Zamboni parity: expired tombstones at the op's stamped MSN act as
    # absent — never stamped, never a neighbor in the arrival scan.
    msn = op["min_seq"]
    ob1, ob2 = st[:, _OB1_SEQ], st[:, _OB2_SEQ]
    rem, rem2 = st[:, _REM_SEQ], st[:, _REM2_SEQ]
    ob1_live = (ob1 != _NR) & (ob1 > msn)
    ob2_live = (ob2 != _NR) & (ob2 > msn)
    expired = ((rem != _NR) & (rem <= msn) & (st[:, _INS_SEQ] <= msn)
               & ~ob1_live & ~ob2_live)

    # --- insert: tie-break index = first active slot with cum >= pos.
    jfirst = _first((cum >= a) & active, slot, S)
    j = torch.where(jfirst < S, jfirst, n)

    # Obliterate-on-arrival: the insert dies iff its nearest non-expired
    # neighbours share a stamp the inserter had not seen from another
    # client; the earliest shared stamp is the remover.
    present = active & ~expired
    left_idx = torch.where(present & (slot < j), slot, -1).amax(
        dim=1, keepdim=True)
    right_idx = _first(present & (slot >= j), slot, S)
    has_left = left_idx >= 0
    has_right = right_idx < S

    def at(plane, idx, valid):
        got = torch.gather(st[:, plane], 1, idx.clamp(0, S - 1))
        return torch.where(valid, got, _NR)

    l1s, l2s = at(_OB1_SEQ, left_idx, has_left), at(_OB2_SEQ, left_idx,
                                                     has_left)
    l1c, l2c = at(_OB1_CLIENT, left_idx, has_left), at(_OB2_CLIENT, left_idx,
                                                       has_left)
    r1s, r2s = at(_OB1_SEQ, right_idx, has_right), at(_OB2_SEQ, right_idx,
                                                      has_right)

    def killer_of(ls, lc):
        shared = (ls != _NR) & ((ls == r1s) | (ls == r2s))
        ok = shared & (ls > ref_seq) & (lc != client)
        return torch.where(ok, ls, _NR)

    k1s, k2s = killer_of(l1s, l1c), killer_of(l2s, l2c)
    kill_seq = torch.minimum(k1s, k2s)
    kill_client = torch.where(k1s <= k2s, l1c, l2c)
    killed = kill_seq != _NR
    kill_seq_or = torch.where(killed, kill_seq, _NR)
    kill_client_or = torch.where(killed, kill_client, -1)

    pv = op["pvals"]
    neg = torch.full_like(seq, -1)
    nr = torch.full_like(seq, _NR)
    newvals = torch.cat([
        op["tstart"], op["tlen"], seq, client, kill_seq_or, kill_client_or,
        nr, neg, kill_seq_or, kill_client_or, nr, neg,
        torch.where(pv == PROP_NOT_TOUCHED, PROP_ABSENT, pv),
    ], dim=1)                                            # (D, 12 + K)
    ins_st = torch.where((slot == j)[:, None, :], newvals[:, :, None],
                         _shift_right_from(st, slot, j))
    st = torch.where(is_ins[:, :, None], ins_st, st)
    n = torch.where(is_ins, n + 1, n)

    # --- remove / annotate / obliterate over [a, b) in the view, on the
    # pre-insert cum/v (the kind masks are exclusive).
    covered = (cum >= a) & (cum + v <= b) & (v > 0) & active
    is_rem_like = is_rem | is_obl
    rem, rem2 = st[:, _REM_SEQ], st[:, _REM2_SEQ]
    ob1, ob2 = st[:, _OB1_SEQ], st[:, _OB2_SEQ]
    first_win = covered & (rem == _NR) & is_rem_like
    again = covered & (rem != _NR) & is_rem_like
    second = again & (rem2 == _NR)
    third = again & (rem2 != _NR)
    # Obliterate also stamps zero-width slots strictly inside the range.
    obl_zero = active & ~expired & (v == 0) & (cum > a) & (cum < b) & is_obl
    first_win = first_win | (obl_zero & (rem == _NR))
    stamp = (covered & is_obl) | obl_zero
    to_ob1 = stamp & (ob1 == _NR)
    to_ob2 = stamp & ~to_ob1 & (ob2 == _NR) & (ob1 != seq)
    ob_over = stamp & (ob1 != _NR) & (ob2 != _NR) & (ob1 != seq) \
        & (ob2 != seq)
    st = st.clone()
    st[:, _OB1_SEQ] = torch.where(to_ob1, seq, ob1)
    st[:, _OB1_CLIENT] = torch.where(to_ob1, client, st[:, _OB1_CLIENT])
    st[:, _OB2_SEQ] = torch.where(to_ob2, seq, ob2)
    st[:, _OB2_CLIENT] = torch.where(to_ob2, client, st[:, _OB2_CLIENT])
    st[:, _REM_SEQ] = torch.where(first_win, seq, rem)
    st[:, _REM_CLIENT] = torch.where(first_win, client, st[:, _REM_CLIENT])
    st[:, _REM2_SEQ] = torch.where(second, seq, rem2)
    st[:, _REM2_CLIENT] = torch.where(second, client, st[:, _REM2_CLIENT])
    overflow = overflow | third.any(dim=1, keepdim=True) \
        | ob_over.any(dim=1, keepdim=True)

    touch = (pv != PROP_NOT_TOUCHED)[:, :, None] & (covered & is_ann)[:, None]
    st[:, _PROPS0:] = torch.where(touch, pv[:, :, None], st[:, _PROPS0:])
    return st, n, overflow


def fold_reference(state: MTState, ops: MTOps) -> MTState:
    """The plain PyTorch fold: every document's op tail applied to its
    state, on whatever device the tensors lie.  Counterpart of the
    reference's ``replay_vmapped`` (full semantics, no chunk-fact
    specialisation) and of its Pallas kernel ``replay_vmapped_pallas``."""
    st = _stack_state(state)
    D, _P, S = st.shape
    n = state.n.to(torch.int32).reshape(D, 1)
    overflow = state.overflow.to(torch.bool).reshape(D, 1)
    # int64: slot indices feed torch.gather
    slot = torch.arange(S, device=st.device)[None, :]
    fields = {f: getattr(ops, f).to(torch.int32) for f in OP_FIELDS}
    pvals = ops.pvals.to(torch.int32)
    for t in range(ops.kind.shape[1]):
        op = {f: x[:, t:t + 1] for f, x in fields.items()}
        op["pvals"] = pvals[:, t]
        st, n, overflow = _apply_op(st, n, overflow, slot, op)
    return _unstack_state(st, n.reshape(D), overflow.reshape(D))


def cold_start(ops: MTOps, S: int) -> MTState:
    """Empty initial state built on the ops' device: documents with no
    base summary start from zeros and sentinels, so only the op arrays
    cross the host link."""
    D = ops.kind.shape[0]
    K = ops.pvals.shape[2]
    dev = ops.kind.device

    def full(fill, shape=(D, S)):
        return torch.full(shape, fill, dtype=torch.int32, device=dev)

    return MTState(
        tstart=full(0), tlen=full(0), ins_seq=full(0), ins_client=full(-1),
        rem_seq=full(_NR), rem_client=full(-1),
        rem2_seq=full(_NR), rem2_client=full(-1),
        ob1_seq=full(_NR), ob1_client=full(-1),
        ob2_seq=full(_NR), ob2_client=full(-1),
        props=full(PROP_ABSENT, (D, S, K)),
        n=full(0, (D,)),
        overflow=torch.zeros((D,), dtype=torch.bool, device=dev),
    )


# ---------------------------------------------------------------------------
# Device half: transfer encodings, export layouts and the state digest
# ---------------------------------------------------------------------------


def _export_fields(ob_rows: bool, ov_rows: bool):
    fields = list(EXPORT_SLOT_FIELDS if ob_rows else NON_OB_SLOT_FIELDS)
    if not ov_rows:
        fields = [f for f in fields if f not in OV_SLOT_FIELDS]
    return fields


def _export_flags(meta: dict):
    """The transfer-layout facts ``(i16, ob_rows, ov_rows, i8,
    props_rows)`` BOTH sides of the export use (dispatch builds the
    buffer, extraction widens it): one derivation point, so they can
    never disagree.  The reference forces the props rows on when its
    ``FF_PALLAS_FOLD`` selects the Pallas fold; the port reads no
    environment, so ``props_rows`` is ``has_props`` (the reference with
    the variable unset)."""
    i16 = bool(meta.get("i16_ok"))
    return (
        i16,
        bool(meta.get("ob_rows", True)),
        bool(meta.get("ov_rows", True)),
        i16 and bool(meta.get("i8_ok")),
        bool(meta.get("has_props", True)),
    )


def _layout_rows(ob_rows: bool, ov_rows: bool, i8: bool,
                 n_props_rows: int) -> int:
    fields = _export_fields(ob_rows, ov_rows)
    if i8:
        n_bytes = len(fields) - 1 + n_props_rows
        return 1 + (n_bytes + 1) // 2  # misc rides the separate output
    return len(fields) + n_props_rows + 1


def export_layout_rows(meta: dict) -> int:
    """Row count of the transfer buffer ``replay_export`` emits for this
    packed chunk's layout facts (elisions + byte packing)."""
    _i16, ob_rows, ov_rows, i8, props_rows = _export_flags(meta)
    return _layout_rows(ob_rows, ov_rows, i8,
                        meta.get("props_K", 1) if props_rows else 0)


def _export_state(final: MTState, doc_base: Optional[torch.Tensor] = None,
                  i16: bool = False, ob_rows: bool = True,
                  ov_rows: bool = True, i8: bool = False,
                  props_rows: bool = True):
    """``[D, rows, S]`` view of everything summary extraction and interval
    replay read from the final state, in one of the reference's transfer
    layouts (its ``_export_state``, in plain PyTorch):

    - int32: the exported slot planes (``tstart`` zeroed on dead slots,
      so export bytes are deterministic), the props planes, and a misc
      row ``[n, overflow, live_len, 0...]``;
    - ``i16``: int16, with live ``tstart`` rebased by ``doc_base`` and
      NOT_REMOVED as ``I16_NOT_REMOVED``;
    - ``i8`` (with ``i16``): every row after ``tstart`` paired into one
      int16 lane (``(a & 0xFF) << 8 | (b & 0xFF)``, NOT_REMOVED as 127),
      and the misc values as a separate ``[D, 4]`` int32 leaf: returns
      ``(rows, misc)``;
    - ``ob_rows`` / ``ov_rows`` / ``props_rows`` False elide the
      obliterate, overlap-remover and props rows.

    Every layout widens back to the int32 one (``widen_export``)."""
    i8 = i8 and i16  # byte packing presupposes the int16 transforms
    D, S = final.tlen.shape
    K = final.props.shape[2]
    dev = final.tlen.device
    slot = torch.arange(S, device=dev)[None, :]
    active = slot < final.n[:, None]
    live = torch.where(active & (final.rem_seq == _NR), final.tlen, 0).sum(
        dim=1, dtype=torch.int32)
    misc = torch.zeros((D, S), dtype=torch.int32, device=dev)
    misc[:, 0] = final.n
    misc[:, 1] = final.overflow.to(torch.int32)
    misc[:, 2] = live
    named = {"tstart": torch.where(active, final.tstart, 0)}
    fields = _export_fields(ob_rows, ov_rows)
    if i16:
        named["tstart"] = torch.where(
            active, final.tstart - doc_base[:, None], 0)
        sentinel = int(I8_NOT_REMOVED) if i8 else int(I16_NOT_REMOVED)
        for f in SENTINEL_SEQ_FIELDS:
            if f in fields:
                val = getattr(final, f)
                named[f] = torch.where(val == _NR, sentinel, val)
    rows = [named.get(f, getattr(final, f)) for f in fields]
    if props_rows:
        rows += [final.props[:, :, k] for k in range(K)]
    if i8:
        byte_rows = rows[1:]
        if len(byte_rows) % 2:
            byte_rows.append(torch.zeros((D, S), dtype=torch.int32,
                                         device=dev))
        packed = [((byte_rows[i] & 0xFF) << 8) | (byte_rows[i + 1] & 0xFF)
                  for i in range(0, len(byte_rows), 2)]
        out = torch.stack([rows[0]] + packed, dim=1).to(torch.int16)
        return out, misc[:, :4].contiguous()
    rows.append(misc)
    out = torch.stack(rows, dim=1).to(torch.int32)
    return out.to(torch.int16) if i16 else out


def export_state(final: MTState) -> torch.Tensor:
    """The int32 full export ``[D, 12 + K + 1, S]`` (``_export_state`` with
    no narrowing and no row elision)."""
    return _export_state(final)


#: fixed per-plane salt ids for the digest mix (the slot planes in export
#: order, props column k at 16 + k): the digest reads the canonical final
#: state, never the transfer buffer, so layouts cannot perturb it
_DIGEST_PROPS_BASE = 16
_DIGEST_SALTS = (0x9E3779B9, 0x85EBCA6B)
_U32 = 0xFFFFFFFF


def _mix_u32(x: torch.Tensor) -> torch.Tensor:
    """splitmix-style avalanche over uint32 values held in int64 (the
    reference's ``_mix_u32``: wrap-around multiplies and logical shifts,
    here as int64 arithmetic masked to 32 bits)."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _U32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _U32
    return x ^ (x >> 16)


def _doc_digests(final: MTState, doc_base: torch.Tensor) -> torch.Tensor:
    """``[D, 2]`` int32 digest of each document's canonical final state,
    bit for bit the reference's ``_doc_digests``: only live slots count,
    ``tstart`` enters relative to the document's arena base, a props key
    the document never set adds zero (set values hash + 1), and ``n``,
    ``live_len`` and ``overflow`` are mixed in; two independently salted
    32-bit lanes."""
    D, S = final.tlen.shape
    K = final.props.shape[2]
    dev = final.tlen.device
    slot = torch.arange(S, device=dev, dtype=torch.int64)[None, :]
    active = slot < final.n[:, None]
    live_len = torch.where(active & (final.rem_seq == _NR), final.tlen,
                           0).sum(dim=1, dtype=torch.int64)
    base = doc_base.to(torch.int64)[:, None]

    def weighted(v, salt_id, salt):
        w = _mix_u32((slot * 0x01000193 + salt_id + salt) & _U32)
        return ((v & _U32) * w & _U32).sum(dim=1)

    lanes = []
    for salt in _DIGEST_SALTS:
        acc = torch.zeros((D,), dtype=torch.int64, device=dev)
        for i, f in enumerate(EXPORT_SLOT_FIELDS):
            plane = getattr(final, f).to(torch.int64)
            if f == "tstart":
                plane = plane - base
            acc = acc + weighted(torch.where(active, plane, 0), i, salt)
        for k in range(K):
            plane = final.props[:, :, k].to(torch.int64)
            v = torch.where(active & (plane != PROP_ABSENT), plane + 1, 0)
            acc = acc + weighted(v, _DIGEST_PROPS_BASE + k, salt)
        acc = acc & _U32
        acc = acc ^ _mix_u32((final.n.to(torch.int64) + salt) & _U32)
        acc = acc ^ _mix_u32((live_len * 3 + salt) & _U32)
        acc = acc ^ torch.where(final.overflow, 0x5BD1E995, 0)
        lanes.append(_mix_u32(acc))
    out = torch.stack(lanes, dim=-1)
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


#: upload-side narrow dtypes (the h2d transfer encoding of
#: ``narrow_ops_for_upload``), per field
_UPLOAD_NARROW_DTYPES = {
    "kind": np.int8, "client": np.int8,
    "seq": np.int16, "ref_seq": np.int16, "min_seq": np.int16,
    "a": np.int16, "b": np.int16, "tstart": np.int16, "tlen": np.int16,
    "pvals": np.int16,
}


#: the narrow upload encoding of each field, as torch dtypes: the op
#: stream per ``_UPLOAD_NARROW_DTYPES``, the warm state int16 but
#: ``overflow``
_UPLOAD_NARROW_TORCH = {
    MTOps: {f: torch.int8 if np.dtype(dt) == np.int8 else torch.int16
            for f, dt in _UPLOAD_NARROW_DTYPES.items()},
    MTState: {f: torch.bool if f == "overflow" else torch.int16
              for f in MTState._fields},
}


def upload_encoding(x) -> bool:
    """Whether an ``MTOps`` or ``MTState`` of tensors is in the narrow
    upload encoding (True: exactly what ``narrow_ops_for_upload`` /
    ``narrow_state_for_upload`` emit) or wide int32 (False).  ``seq`` /
    ``ins_seq`` names the encoding; any other dtype there, or a field off
    that encoding, raises ``TypeError``: only the exact narrow encoding
    was rebased, so nothing else may be un-rebased.  Every decode (the
    plain ``_widen_ops`` / ``_widen_state`` and the kernel's prologue)
    checks through here."""
    kind = type(x)
    key, what, narrower = (
        ("seq", "op stream", "narrow_ops_for_upload") if kind is MTOps
        else ("ins_seq", "state", "narrow_state_for_upload"))
    encoding = getattr(x, key).dtype
    if encoding == torch.int16:
        want = _UPLOAD_NARROW_TORCH[kind]
    elif encoding == torch.int32:
        want = {f: torch.bool if f == "overflow" else torch.int32
                for f in kind._fields}
    else:
        raise TypeError(
            f"{what} has {key} dtype {encoding}; expected int32 (wide) or "
            f"the int16 {narrower} encoding")
    bad = [f for f in kind._fields if getattr(x, f).dtype != want[f]]
    if bad:
        raise TypeError(f"{what} fields {bad} do not match the {encoding} "
                        f"encoding of {key}")
    return encoding == torch.int16


def narrow_ops_for_upload(ops: MTOps, meta: dict) -> MTOps:
    """Narrow a packed numpy op stream for the h2d link: int16 rows (int8
    for kind/client), with insert ``tstart`` rebased per document
    (``tstart - doc_base[d]``).  The device widens it back
    (``_widen_ops``, or the kernel's prologue), so this is purely a
    transfer encoding.

    Applies only when the chunk's ``i16_ok`` fact holds AND a direct
    bounds re-check of every field passes: any violation falls back to
    the wide upload, never truncates.  Streams already on a device, or
    already narrow, pass through unchanged.  (The reference also reads
    ``FF_UPLOAD_NARROW``; the port reads no environment and behaves as
    the reference with it unset.)"""
    if (not meta.get("i16_ok")
            or not isinstance(ops.kind, np.ndarray)
            or ops.seq.dtype != np.int32):
        return ops
    doc_base = np.asarray(meta["doc_base"], np.int32)
    is_ins = ops.kind == K_INSERT
    # Non-insert rows must carry tstart == 0 (pack invariant; the fold
    # reads op tstart only under is_ins) for the rebase to round-trip.
    if int(np.abs(np.where(is_ins, 0, ops.tstart)).max(initial=0)) != 0:
        return ops
    rebased = np.where(is_ins, ops.tstart - doc_base[:, None], 0)
    narrow = {"tstart": rebased}
    for f in MTOps._fields:
        if f != "tstart":
            narrow[f] = getattr(ops, f)
    for f, dt in _UPLOAD_NARROW_DTYPES.items():
        info = np.iinfo(dt)
        v = narrow[f]
        if not (int(v.min(initial=0)) >= info.min
                and int(v.max(initial=0)) <= info.max):
            return ops  # bounds re-check failed → wide upload
    return MTOps(**{f: narrow[f].astype(_UPLOAD_NARROW_DTYPES[f])
                    for f in MTOps._fields})


def narrow_state_for_upload(state: MTState, meta: dict) -> MTState:
    """Narrow a warm chunk's numpy base state for the h2d link: int16
    planes with the NOT_REMOVED sentinel remapped to ``I16_NOT_REMOVED``
    and live-slot ``tstart`` rebased per document (dead slots are zero by
    the pack invariant, re-checked here); ``props`` and ``n`` narrow under
    the same bound, ``overflow`` stays bool.  Any bounds violation (a real
    seq equal to the remapped sentinel included) falls back to the wide
    upload."""
    if (not meta.get("i16_ok")
            or not isinstance(state.tstart, np.ndarray)
            or state.ins_seq.dtype != np.int32):
        return state
    doc_base = np.asarray(meta["doc_base"], np.int32)
    S = state.tstart.shape[1]
    live = np.arange(S, dtype=np.int32)[None, :] < state.n[:, None]
    if int(np.abs(np.where(live, 0, state.tstart)).max(initial=0)) != 0:
        return state  # dead slots must be zero for the rebase round trip
    info = np.iinfo(np.int16)
    narrow = {}
    for f in EXPORT_SLOT_FIELDS:
        v = getattr(state, f)
        if f == "tstart":
            v = np.where(live, v - doc_base[:, None], 0)
        elif f in SENTINEL_SEQ_FIELDS:
            # Real values must stay STRICTLY below the remapped sentinel
            # (I16_LIMIT): a genuine 32767 would widen back as NOT_REMOVED
            # and resurrect a removed segment.
            reals = np.where(v == NOT_REMOVED, 0, v)
            if int(reals.max(initial=0)) > I16_LIMIT:
                return state
            v = np.where(v == NOT_REMOVED, np.int32(I16_NOT_REMOVED), v)
        if not (info.min <= int(v.min(initial=0))
                and int(v.max(initial=0)) <= info.max):
            return state
        narrow[f] = v.astype(np.int16)
    if not (int(state.props.min(initial=0)) >= info.min
            and int(state.props.max(initial=0)) <= info.max
            and int(state.n.max(initial=0)) <= info.max):
        return state
    return MTState(
        **narrow,
        props=state.props.astype(np.int16),
        n=state.n.astype(np.int16),
        overflow=state.overflow,
    )


def _widen_ops(ops: MTOps, doc_base: torch.Tensor) -> MTOps:
    """Inverse of ``narrow_ops_for_upload`` on tensors (identity on int32
    streams): a cast per field plus the insert-tstart un-rebase.  Only the
    exact encoding the narrower emits (int16 seq rows) is un-rebased; any
    other encoding was never rebased, so ``upload_encoding`` refuses it."""
    if not upload_encoding(ops):
        return ops
    w = {f: getattr(ops, f).to(torch.int32) for f in MTOps._fields}
    w["tstart"] = torch.where(w["kind"] == K_INSERT,
                              w["tstart"] + doc_base[:, None], 0)
    return MTOps(**w)


def _widen_state(state: MTState, doc_base: torch.Tensor) -> MTState:
    """Inverse of ``narrow_state_for_upload`` on tensors (identity on int32
    states); refuses unknown encodings like ``_widen_ops``."""
    if not upload_encoding(state):
        return state
    w = {f: getattr(state, f).to(torch.int32) for f in EXPORT_SLOT_FIELDS}
    n = state.n.to(torch.int32)
    S = state.tstart.shape[1]
    live = torch.arange(S, device=n.device)[None, :] < n[:, None]
    w["tstart"] = torch.where(live, w["tstart"] + doc_base[:, None], 0)
    for f in SENTINEL_SEQ_FIELDS:
        w[f] = torch.where(w[f] == int(I16_NOT_REMOVED), _NR, w[f])
    return MTState(**w, props=state.props.to(torch.int32), n=n,
                   overflow=state.overflow)


def export_reference(state: Optional[MTState], ops: MTOps,
                     doc_base: torch.Tensor, layout, digest: bool = False,
                     S: Optional[int] = None):
    """The plain fold+export on whatever device the tensors lie: decode
    (``_widen_ops`` / ``_widen_state``, or ``cold_start`` when ``state``
    is None), ``fold_reference``, ``_export_state`` in ``layout`` (the
    ``_export_flags`` tuple) and, with ``digest``, ``_doc_digests`` as the
    last leaf.  The CPU path of ``fold_cuda.fold_export`` and the card's
    yardstick for the kernel's fold+export build."""
    ops = _widen_ops(ops, doc_base)
    state = cold_start(ops, int(S)) if state is None \
        else _widen_state(state, doc_base)
    return export_final(fold_reference(state, ops), doc_base, layout, digest)


def export_final(final: MTState, doc_base: torch.Tensor, layout,
                 digest: bool = False):
    """The export leaves of a folded state: ``_export_state`` in ``layout``
    (the ``_export_flags`` tuple) and, with ``digest``, ``_doc_digests``
    as the last leaf (the structure ``split_export_digest`` takes apart)."""
    ex = _export_state(final, doc_base, *layout)
    if not digest:
        return ex
    dig = _doc_digests(final, doc_base)
    return ex + (dig,) if isinstance(ex, tuple) else (ex, dig)


def split_export_digest(export, digested: bool):
    """``(core, digest_or_None)`` for a ``replay_export`` handle: with
    ``digest=True`` the digest rides as the LAST leaf; the core keeps the
    exact shape the non-digest path produces (bare buffer, or
    ``(rows, misc)`` for i8 layouts)."""
    if not digested:
        return export, None
    if not (isinstance(export, tuple) and len(export) >= 2):
        raise ValueError("a digested export is a tuple with the digest last")
    core = export[0] if len(export) == 2 else export[:-1]
    return core, export[-1]


def _leaf_to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _take_docs(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The documents ``idx`` of a device leaf (one gather along the
    document axis; the reference's ``jnp.take`` under ``jit``)."""
    return torch.index_select(a, 0, idx)


def _host_view(a) -> Optional[np.ndarray]:
    """Zero-copy numpy view of a leaf the host can read (a numpy array, or
    a tensor on the CPU), or None when it lies on the card.  On the CPU
    the "d2h link" IS host memory: the delta fetch copies exactly the
    requested rows."""
    if isinstance(a, np.ndarray):
        return a
    if a.device.type == "cpu":
        return a.numpy()
    return None


def gather_export_rows(export, idx: np.ndarray, fetch=None):
    """Fetch ONLY the documents in ``idx`` from an export — the
    delta-download fetch.  Returns ``(rows, moved_bytes)`` where each leaf
    of ``rows`` has exactly ``len(idx)`` document rows and
    ``moved_bytes`` counts what actually crossed the d2h link:

    - on host-readable leaves, exactly the requested rows, copied;
    - on the card, ``idx`` padded to ``next_bucket_fine(m, floor=8)``
      (the reference's bucketed gather; the pad rows DO cross and are
      counted), one ``index_select`` along the document axis and the copy
      of those rows — or, when the padded count reaches the buffer's
      rows, the whole buffer, sliced on the host.

    ``fetch`` copies a list of device tensors to numpy (default: a plain
    ``.cpu()`` each); a handle that fetches itself (the pipeline's
    ``DeviceExport``) is asked to gather."""
    gather = getattr(export, "gather_rows", None)
    if gather is not None:
        return gather(idx)
    fetch = fetch or (lambda xs: [_leaf_to_numpy(x) for x in xs])
    leaves = export if isinstance(export, tuple) else (export,)
    rows = np.asarray(idx, np.intp)
    m = rows.shape[0]
    bucket = next_bucket_fine(m, floor=8)
    out: List[Any] = [None] * len(leaves)
    moved = 0
    dev_idx = None
    pending = []  # (leaf position, device tensor to copy, whole buffer)
    for i, a in enumerate(leaves):
        view = _host_view(a)
        if view is not None:
            out[i] = view[rows]
            moved += out[i].nbytes
        elif bucket >= a.shape[0]:
            pending.append((i, a, True))
        else:
            if dev_idx is None:
                padded = np.concatenate(
                    [rows, np.repeat(rows[-1:], bucket - m)])
                dev_idx = torch.from_numpy(padded.astype(np.int64)).to(
                    a.device)
            pending.append((i, _take_docs(a, dev_idx), False))
    if pending:
        for (i, _a, whole), host in zip(pending,
                                        fetch([a for _i, a, _w in pending])):
            moved += host.nbytes
            out[i] = host[rows] if whole else host[:m]
    return (tuple(out) if isinstance(export, tuple) else out[0]), moved


def export_to_numpy(export):
    """Fetch an export to numpy: a leaf, or a tuple of leaves for the i8
    layout's ``(rows, misc)`` pair (and a digest).  A handle that fetches
    itself (the pipeline's ``DeviceExport``) is asked to."""
    fetch = getattr(export, "to_numpy", None)
    if fetch is not None:
        return fetch()
    if isinstance(export, tuple):
        return tuple(_leaf_to_numpy(x) for x in export)
    return _leaf_to_numpy(export)


def replay_export(state: Optional[MTState], ops: MTOps, meta: dict,
                  S: Optional[int] = None, digest: bool = False,
                  doc_base: Optional[torch.Tensor] = None,
                  device="cuda"):
    """Fold a packed chunk and export it in the layout its facts allow
    (``_export_flags``): the reference's ``replay_export``.  ``state=None``
    folds a cold chunk of ``S`` slots (its empty state built on the
    device, no zero upload).  Numpy inputs are narrowed for the upload
    (``narrow_ops_for_upload`` / ``narrow_state_for_upload``) and copied
    to ``device``; tensors already on a device are used as they are (and
    name the device).  ``digest=True`` adds the ``[D, 2]`` state digest as
    the last leaf (``split_export_digest``).  ``doc_base`` (a tensor on the
    device) must equal ``meta["doc_base"]``; by default it is that when
    the layout or the digest reads it, zeros otherwise.

    The fold+export is ``fold_cuda.fold_export``: the kernel on the card,
    the plain ``export_reference`` on the CPU.  Returns the leaves on that
    device, asynchronously on the card."""
    from ..convert import tensors_to
    from .fold_cuda import fold_export

    layout = _export_flags(meta)
    dev = ops.kind.device if isinstance(ops.kind, torch.Tensor) \
        else resolve_device(device)
    D = ops.kind.shape[0]
    if doc_base is None:
        # The digest rebases tstart per document even on int32 layouts, so
        # an unchanged document digests the same across repacks.
        base = meta["doc_base"] if (layout[0] or digest) else \
            np.zeros((D,), np.int32)
        doc_base = torch.from_numpy(
            np.ascontiguousarray(base, np.int32)).to(dev)
    ops = tensors_to(narrow_ops_for_upload(ops, meta), dev)
    if state is not None:
        state = tensors_to(narrow_state_for_upload(state, meta), dev)
    return fold_export(state, ops, doc_base, layout, digest, S=S)


def state_dict_from_export(export_np: np.ndarray) -> dict:
    """Adapt a downloaded export buffer back to the state_np dict shape the
    extraction/interval code consumes (zero-copy row views)."""
    K = export_np.shape[1] - len(EXPORT_SLOT_FIELDS) - 1
    out = {
        f: export_np[:, i, :] for i, f in enumerate(EXPORT_SLOT_FIELDS)
    }
    out["props"] = np.moveaxis(
        export_np[:, len(EXPORT_SLOT_FIELDS):len(EXPORT_SLOT_FIELDS) + K, :],
        1, 2,
    )
    misc = export_np[:, -1, :]
    out["n"] = misc[:, 0]
    out["overflow"] = misc[:, 1]
    out["live_len"] = misc[:, 2]
    return out


# ---------------------------------------------------------------------------
# Host side: packing and canonical summary extraction (copied)
# ---------------------------------------------------------------------------


@dataclass
class MergeTreeDocInput:
    """One document's catch-up work item: optional base summary + op tail."""

    doc_id: str
    ops: Sequence[SequencedMessage]   # sequence-op contents, ascending seq
    base_records: Optional[List[dict]] = None  # normalized summary body
    final_seq: int = 0    # head seq after the tail (for the summary header)
    final_msn: int = 0    # final minimumSequenceNumber
    base_seq: int = 0     # seq of the base summary (for oracle fallback)
    base_msn: int = 0     # minSeq of the base summary
    base_intervals: Optional[Dict[str, dict]] = None  # intervals blob content
    # Native fast path: the ops pre-encoded as the liboppack binary record
    # stream (ops/native_pack.py) + the encoder's doc-local intern tables
    # (client ids; property keys / values when the stream annotates).
    # Interval ops never ride the stream.  When set, ``ops`` may be empty
    # (the stream is authoritative) — C++ fills this doc's arrays,
    # translating doc-local property ids into the batch-global spaces.
    binary_ops: Optional[bytes] = None
    binary_clients: Optional[Sequence[str]] = None
    binary_prop_keys: Optional[Sequence[str]] = None
    binary_values: Optional[Sequence[Any]] = None
    #: attribution-enabled document (SURVEY §1 layer 8): the summary gains
    #: an "attribution" blob of pre-clamp insert seqs per merged sub-run
    #: (byte-identical to SharedString.summarize with an attributor).  The
    #: export already carries pre-clamp ins_seq — clamping is host-side —
    #: so this is pure extraction work; such docs take the Python record
    #: path (the C++ extractor emits bodies only).
    attribution: bool = False
    #: Opaque identity of the (document, base summary, storage generation)
    #: this tail extends — set by callers that want the pipeline's cache
    #: tiers to reuse packed windows, resident buffers and summaries
    #: across calls.  The contract: two inputs with equal tokens draw their
    #: ops from the SAME append-only sequenced stream over the SAME base,
    #: so a shared (first_seq .. last_seq) prefix is byte-identical.  None
    #: (the default) opts the document out of every cache tier.
    cache_token: Optional[tuple] = None


class _DocPack:
    """Per-document host bookkeeping during packing."""

    def __init__(self) -> None:
        self.clients = Interner()
        self.interval_ops: List[SequencedMessage] = []
        self.needs_fallback = False

    def client_idx(self, client_id) -> int:
        if client_id is None:
            return -1
        return self.clients.intern(client_id)


def fill_sequence_op_rows(op, d: int, t: int, msgs, pack, arena,
                          key_id, values) -> int:
    """Fill doc ``d``'s op rows from a message list, starting after row
    ``t``.  Interval ops route into ``pack.interval_ops``; ``key_id`` maps
    a property key to its chunk-global column.  Returns the last row
    filled."""
    for msg in msgs:
        contents = msg.contents
        kind = contents["kind"]
        if kind.startswith("interval"):
            for cl in ([msg.client_id] if msg.client_id else []):
                pack.client_idx(cl)
            pack.interval_ops.append(msg)
            continue
        t += 1
        op["seq"][d, t] = msg.seq
        op["client"][d, t] = pack.client_idx(msg.client_id)
        op["ref_seq"][d, t] = msg.ref_seq
        op["min_seq"][d, t] = msg.min_seq
        if kind == "insert":
            op["kind"][d, t] = K_INSERT
            op["a"][d, t] = contents["pos"]
            op["tstart"][d, t] = arena.append(contents["text"])
            op["tlen"][d, t] = len(contents["text"])
        elif kind == "remove":
            op["kind"][d, t] = K_REMOVE
            op["a"][d, t] = contents["start"]
            op["b"][d, t] = contents["end"]
        elif kind == "obliterate":
            op["kind"][d, t] = K_OBLITERATE
            op["a"][d, t] = contents["start"]
            op["b"][d, t] = contents["end"]
        elif kind == "annotate":
            op["kind"][d, t] = K_ANNOTATE
            op["a"][d, t] = contents["start"]
            op["b"][d, t] = contents["end"]
        else:
            raise ValueError(f"unknown sequence op kind {kind!r}")
        for key, value in (contents.get("props") or {}).items():
            op["pvals"][d, t, key_id(key)] = (
                PROP_ABSENT if value is None else values.intern(value)
            )
    return t


def pack_mergetree_batch(docs: Sequence[MergeTreeDocInput]):
    """Pack documents into uniform-shape numpy arrays + host metadata.

    Returns (state_arrays, op_arrays, meta) where meta carries everything
    needed to rebuild canonical summaries from the final device state.
    The arrays and meta equal the reference's ``pack_mergetree_batch``;
    the i16/i8/row-elision facts pick the transfer layouts
    (``_export_flags``, ``narrow_ops_for_upload``).
    """
    prop_keys = Interner()
    values = Interner()
    arena = TextArena()
    doc_packs = [_DocPack() for _ in docs]

    # Pre-scan for the shared property-key vocabulary K.  Binary-stream
    # docs contribute their encoder-local key tables.
    for doc in docs:
        if doc.base_records:
            for rec in doc.base_records:
                for key in rec.get("p", {}):
                    prop_keys.intern(key)
        if doc.binary_ops is not None:
            for key in (doc.binary_prop_keys or []):
                prop_keys.intern(key)
            continue
        for msg in doc.ops:
            op = msg.contents
            if op["kind"].startswith("interval"):
                continue
            for key in (op.get("props") or {}):
                prop_keys.intern(key)
    # Power-of-two buckets: shapes stay stable across batches.
    K = next_bucket(max(len(prop_keys), 1), floor=1)
    binary_counts = {}
    for i, d in enumerate(docs):
        if d.binary_ops is not None:
            if d.base_records:
                # Base-record clients would shift the encoder's dense client
                # ids — a silent misattribution, so refuse (warm-start docs
                # take the message-list path).
                raise ValueError(
                    f"{d.doc_id}: binary_ops cannot be combined with "
                    f"base_records"
                )
            binary_counts[i] = count_stream(d.binary_ops)
    text_op_counts = [
        binary_counts[i][0] if i in binary_counts else
        sum(1 for m in d.ops if not m.contents["kind"].startswith("interval"))
        for i, d in enumerate(docs)
    ]
    # S and T use the finer bucket ladder: both are pure per-element costs.
    T = next_bucket_fine(max(text_op_counts, default=1), floor=16)
    base_counts = [len(d.base_records or []) for d in docs]
    S = max(
        (bc + 2 * t for bc, t in zip(base_counts, text_op_counts)), default=1
    )
    S = next_bucket_fine(max(S, 1), floor=32)

    D = len(docs)
    st = {
        "tstart": np.zeros((D, S), np.int32),
        "tlen": np.zeros((D, S), np.int32),
        "ins_seq": np.zeros((D, S), np.int32),
        "ins_client": np.full((D, S), -1, np.int32),
        "rem_seq": np.full((D, S), NOT_REMOVED, np.int32),
        "rem_client": np.full((D, S), -1, np.int32),
        "rem2_seq": np.full((D, S), NOT_REMOVED, np.int32),
        "rem2_client": np.full((D, S), -1, np.int32),
        "ob1_seq": np.full((D, S), NOT_REMOVED, np.int32),
        "ob1_client": np.full((D, S), -1, np.int32),
        "ob2_seq": np.full((D, S), NOT_REMOVED, np.int32),
        "ob2_client": np.full((D, S), -1, np.int32),
        "props": np.full((D, S, K), PROP_ABSENT, np.int32),
        "n": np.zeros((D,), np.int32),
        "overflow": np.zeros((D,), np.bool_),
    }
    op = {
        "kind": np.zeros((D, T), np.int32),
        "seq": np.zeros((D, T), np.int32),
        "client": np.zeros((D, T), np.int32),
        "ref_seq": np.zeros((D, T), np.int32),
        "min_seq": np.zeros((D, T), np.int32),
        "a": np.zeros((D, T), np.int32),
        "b": np.zeros((D, T), np.int32),
        "tstart": np.zeros((D, T), np.int32),
        "tlen": np.zeros((D, T), np.int32),
        "pvals": np.full((D, T, K), PROP_NOT_TOUCHED, np.int32),
    }

    doc_base = np.zeros((D,), np.int32)
    base_has_ob = False
    base_has_ro = False
    base_max_tlen = 0
    # One raw-pointer packer per chunk: base addresses captured once, no
    # per-doc ndarray marshalling (see native_pack.ChunkPacker).
    from .native_pack import chunk_packer, pack_doc_row

    packer = chunk_packer(op) if binary_counts else None
    for d, doc in enumerate(docs):
        pack = doc_packs[d]
        doc_base[d] = len(arena)
        if known_oracle_fallback(doc):
            # Docs routed here without the partition_replay pre-filter
            # still get the oracle (pack-time parity).
            pack.needs_fallback = True
        for s, rec in enumerate(doc.base_records or []):
            st["tstart"][d, s] = arena.append(rec["t"])
            st["tlen"][d, s] = len(rec["t"])
            st["ins_seq"][d, s] = rec["s"]
            st["ins_client"][d, s] = pack.client_idx(rec["c"])
            if "rs" in rec:
                st["rem_seq"][d, s] = rec["rs"]
                st["rem_client"][d, s] = pack.client_idx(rec.get("rc"))
            ob = rec.get("ob", [])
            if ob:
                base_has_ob = True
                st["ob1_seq"][d, s] = ob[0][0]
                st["ob1_client"][d, s] = pack.client_idx(ob[0][1])
                if len(ob) > 1:
                    st["ob2_seq"][d, s] = ob[1][0]
                    st["ob2_client"][d, s] = pack.client_idx(ob[1][1])
                if len(ob) > 2:
                    pack.needs_fallback = True  # device tracks two stamps
            base_max_tlen = max(base_max_tlen, len(rec["t"]))
            ro = rec.get("ro", [])
            if ro:
                base_has_ro = True
                # Second-remover slot is exact for one overlap remover; the
                # base summary doesn't carry overlap seqs, but any value
                # below the base seq is faithful (it sequenced before every
                # tail op).  >1 overlap removers → oracle fallback.
                st["rem2_seq"][d, s] = doc.base_seq
                st["rem2_client"][d, s] = pack.client_idx(ro[0])
                if len(ro) > 1:
                    pack.needs_fallback = True
            for key, value in rec.get("p", {}).items():
                st["props"][d, s, prop_keys.intern(key)] = values.intern(value)
        st["n"][d] = len(doc.base_records or [])

        if doc.binary_ops is not None:
            # Native fast path: C++ fills this doc's rows in one pass,
            # translating encoder-local property ids to the batch-global
            # intern spaces via the maps.
            for client in (doc.binary_clients or []):
                pack.client_idx(client)
            key_map = val_map = None
            if doc.binary_prop_keys:
                key_map = np.asarray(
                    [prop_keys.intern(k) for k in doc.binary_prop_keys],
                    np.int32,
                )
            if doc.binary_values:
                val_map = np.asarray(
                    [values.intern(v) for v in doc.binary_values],
                    np.int32,
                )
            doc_bytes = bytearray()
            if packer is not None:
                packer.pack(doc.binary_ops, d, len(arena), doc_bytes,
                            text_bytes=binary_counts[d][1],
                            key_map=key_map, val_map=val_map)
            else:
                row = {key: op[key][d]
                       for key in ("kind", "seq", "client", "ref_seq",
                                   "min_seq", "a", "b", "tstart", "tlen",
                                   "pvals")}
                pack_doc_row(doc.binary_ops, row, K, len(arena), doc_bytes,
                             text_bytes=binary_counts[d][1],
                             key_map=key_map, val_map=val_map)
            arena.append(doc_bytes.decode("utf-8"))
            continue

        fill_sequence_op_rows(op, d, -1, doc.ops, pack, arena,
                              prop_keys.intern, values)

    # int16-export eligibility: every value the final state can hold must fit
    # strictly under the int16 sentinel.
    max_doc_chars = 0
    for d in range(D):
        end = doc_base[d + 1] if d + 1 < D else len(arena)
        max_doc_chars = max(max_doc_chars, int(end) - int(doc_base[d]))
    max_seq = max(
        int(op["seq"].max(initial=0)),
        max((d.final_seq for d in docs), default=0),
        max((d.base_seq for d in docs), default=0),
    )
    max_clients = max((len(p.clients) for p in doc_packs), default=0)
    i16_ok = (
        max_seq < I16_LIMIT
        and max_doc_chars < I16_LIMIT
        and S < I16_LIMIT
        and len(values) < I16_LIMIT
        and max_clients < I16_LIMIT
    )
    # int8 pair-packing eligibility: every byte-row value fits a signed
    # byte.
    real_ops = op["kind"] != K_NOOP
    max_tlen = max(int(op["tlen"].max(initial=0)), base_max_tlen)
    i8_ok = (
        i16_ok
        and max_seq < I8_LIMIT
        and max_tlen < I8_LIMIT
        and len(values) < I8_LIMIT
        and max_clients < I8_LIMIT
    )
    # Overlap-remover rows are live only if a second remover can occur:
    # an op authored against a lagging view, or a base record carrying
    # overlap removers.
    sequential = not bool(
        (real_ops & (op["ref_seq"] != op["seq"] - 1)).any()
    )
    meta = {
        "doc_packs": doc_packs,
        "prop_keys": list(prop_keys.values),
        "values": values,
        "arena": arena,
        "docs": docs,
        "doc_base": doc_base,
        "_S": S,  # the padded slot bucket (cold-start builders)
        "i16_ok": i16_ok,
        "i8_ok": i8_ok,
        "props_K": K,
        "ob_rows": base_has_ob or bool((op["kind"] == K_OBLITERATE).any()),
        "ov_rows": base_has_ro or not sequential,
        "has_props": len(prop_keys) > 0,
        "sequential": sequential,
    }
    return MTState(**st), MTOps(**op), meta


def _extract_records(meta, state_np: dict, d: int,
                     return_keys: bool = False):
    """Device state → the oracle's normalized record list (host side).

    ``return_keys=True`` additionally returns the ATTRIBUTION KEYS,
    mirroring ``MergeTreeOracle.normalized_records(return_keys=True)``:
    for each emitted record whose seq got clamped, the pre-clamp insert
    seqs of its merged sub-runs as ``[record_idx, [[chars, seq], ...]]``
    (the export's ins_seq column is pre-clamp — clamping happens here)."""
    doc = meta["docs"][d]
    pack = meta["doc_packs"][d]
    arena: TextArena = meta["arena"]
    prop_keys = meta["prop_keys"]
    values: Interner = meta["values"]
    msn = doc.final_msn
    records: List[dict] = []
    run_keys: List[Optional[list]] = []
    n = int(state_np["n"][d])
    for s in range(n):
        rs = int(state_np["rem_seq"][d, s])
        removed = rs != NOT_REMOVED
        stamps = []
        for o in ("ob1", "ob2"):
            o_s = int(state_np[f"{o}_seq"][d, s])
            if o_s != NOT_REMOVED and o_s > msn:
                oc = int(state_np[f"{o}_client"][d, s])
                stamps.append([o_s, pack.clients.lookup(oc)])
        if removed and rs <= msn \
                and int(state_np["ins_seq"][d, s]) <= msn and not stamps:
            continue  # expired tombstone (active stamps pin it)
        ins_seq = int(state_np["ins_seq"][d, s])
        ins_client = int(state_np["ins_client"][d, s])
        if ins_seq <= msn:
            seq_out, client_out = 0, None
        else:
            seq_out = ins_seq
            client_out = pack.clients.lookup(ins_client)
        rec = {
            "t": arena.slice(
                int(state_np["tstart"][d, s]), int(state_np["tlen"][d, s])
            ),
            "s": seq_out,
            "c": client_out,
        }
        if removed:
            rec["rs"] = rs
            rc = int(state_np["rem_client"][d, s])
            rec["rc"] = pack.clients.lookup(rc) if rc >= 0 else None
        if stamps:
            rec["ob"] = stamps
        rc2 = int(state_np["rem2_client"][d, s])
        if rc2 >= 0:
            rec["ro"] = [pack.clients.lookup(rc2)]
        props = {}
        for k, key in enumerate(prop_keys):
            vid = int(state_np["props"][d, s, k])
            if vid != PROP_ABSENT:
                props[key] = values.lookup(vid)
        if props:
            rec["p"] = dict(sorted(props.items()))
        if records:
            prev = records[-1]
            if (
                prev["s"] == rec["s"]
                and prev["c"] == rec["c"]
                and prev.get("rs") == rec.get("rs")
                and prev.get("rc") == rec.get("rc")
                and prev.get("ob") == rec.get("ob")
                and prev.get("ro") == rec.get("ro")
                and prev.get("p") == rec.get("p")
            ):
                prev["t"] += rec["t"]
                runs = run_keys[-1]
                if runs is not None:
                    if runs[-1][1] == ins_seq:
                        runs[-1][0] += len(rec["t"])  # same author run
                    else:
                        runs.append([len(rec["t"]), ins_seq])
                continue
        records.append(rec)
        run_keys.append(
            [[len(rec["t"]), ins_seq]] if rec["s"] == 0 else None
        )
    if not return_keys:
        return records
    keys = [
        [i, runs] for i, runs in enumerate(run_keys)
        if runs is not None and any(seq for _chars, seq in runs)
    ]
    return records, keys


def known_oracle_fallback(doc: MergeTreeDocInput) -> bool:
    # Memoized per doc object: partition_replay pre-filters with this and
    # pack-time parity re-checks it.
    cached = getattr(doc, "_fallback_verdict", None)
    if cached is not None:
        return cached
    verdict = _known_oracle_fallback_uncached(doc)
    doc._fallback_verdict = verdict
    return verdict


def _known_oracle_fallback_uncached(doc: MergeTreeDocInput) -> bool:
    """True when a doc is known *before packing* to need the oracle path:
    >1 overlap remover on a base record (the device tracks exactly two
    removers and the base format carries no overlap seqs), >2 obliterate
    stamps on a base record (two device stamp slots), or interval ops
    mixed with obliterate ops (reference-slide timing over obliterated
    segments is host-folded only through the oracle)."""
    for r in doc.base_records or []:
        if len(r.get("ro", [])) > 1 or len(r.get("ob", [])) > 2:
            return True
    has_interval = doc.base_intervals is not None
    has_obl = False
    for msg in doc.ops:
        kind = msg.contents.get("kind", "")
        if kind.startswith("interval"):
            has_interval = True
        elif kind == "obliterate":
            has_obl = True
    if doc.binary_ops is not None and has_interval and not has_obl:
        from .native_pack import binary_has_obliterate

        has_obl = binary_has_obliterate(doc.binary_ops)
    if has_obl and has_interval:
        return True
    return False


def oracle_fallback_summary(doc: MergeTreeDocInput) -> SummaryTree:
    """Full oracle replay of one document — the exactness escape hatch for
    the shapes the device path flags (>2 removers or stamps on one
    segment, or a base summary the device state cannot carry)."""
    from ..dds.sequence import SharedString

    replica = SharedString(doc.doc_id)
    if doc.attribution:
        # Attribution-enabled docs must emit their keys blob on fallback
        # too (summarize keys on the flag alone; table reads are container
        # state, not needed here).
        from ..runtime.attributor import Attributor

        replica._attributor = Attributor()
    if doc.base_records is not None:
        replica.tree.load_records(doc.base_records, doc.base_seq, doc.base_msn)
        for label, obj in (doc.base_intervals or {}).items():
            replica.get_interval_collection(label).load_obj(obj)
    ops = doc.ops
    if doc.binary_ops is not None and not ops:
        from .native_pack import decode_string_ops

        ops = decode_string_ops(doc.binary_ops,
                                list(doc.binary_clients or []),
                                prop_keys=doc.binary_prop_keys,
                                values=doc.binary_values)
    for msg in ops:
        replica.process(msg, local=False)
    replica.advance(doc.final_seq, doc.final_msn)
    return replica.summarize()


def _widen_desc(ob_rows: bool, ov_rows: bool, i8: bool, props_rows: bool,
                n_props: int):
    """The per-canonical-row descriptor table ``oppack_widen`` consumes:
    [mode, arg, fill, flags] x (13 + K) rows, in ``widen_export``'s field
    order (the same ``_export_fields`` derivation)."""
    fields = _export_fields(ob_rows, ov_rows)

    def src_of(f: str):
        if not i8:
            return 1, fields.index(f)                       # ROW16
        if f == "tstart":
            return 1, 0                                     # 16-bit lane
        i = fields.index(f) - 1                             # byte index
        return 2, (1 + i // 2) * 2 + (i % 2)                # PAIR8

    desc = []
    for f in EXPORT_SLOT_FIELDS:
        if f in fields:
            mode, arg = src_of(f)
            flags = (1 if f in SENTINEL_SEQ_FIELDS else 0) \
                | (2 if f == "tstart" else 0)
            desc.append((mode, arg, 0, flags))
        else:
            fill = int(NOT_REMOVED) if f.endswith("_seq") else -1
            desc.append((0, 0, fill, 0))
    for k in range(n_props):
        if props_rows:
            if i8:
                i = len(fields) - 1 + k
                desc.append((2, (1 + i // 2) * 2 + (i % 2), 0, 0))
            else:
                desc.append((1, len(fields) + k, 0, 0))
        else:
            desc.append((0, 0, int(PROP_ABSENT), 0))
    if i8:
        desc.append((3, 0, 0, 0))                           # stitched misc
    else:
        n_src = len(fields) + (n_props if props_rows else 0) + 1
        desc.append((1, n_src - 1, 0, 0))                   # misc row
    return np.asarray(desc, np.int32).reshape(-1)


def widen_export_native(export_np, doc_base, ob_rows: bool, ov_rows: bool,
                        i8: bool, n_props: int, props_rows: bool):
    """C++ single-pass widen (``oppack_widen`` in ``csrc/oppack.cpp``) of
    a narrow export buffer to the canonical ``[D, 13 + K, S]`` int32
    layout, byte-identical to ``widen_export``.  Returns None when it does
    not apply (already int32, or no native library)."""
    from .native_pack import load_library

    misc_np = None
    if isinstance(export_np, tuple):
        export_np, misc_np = export_np
    if export_np.dtype != np.int16:
        return None
    lib = load_library()
    if lib is None:
        return None
    D, R_src, S = export_np.shape
    desc = _widen_desc(ob_rows, ov_rows, i8, props_rows, n_props)
    R_canon = len(desc) // 4
    dst = np.empty((D, R_canon, S), np.int32)
    src = np.ascontiguousarray(export_np, np.int16)
    if i8:
        if misc_np is None:
            raise ValueError("an i8 widen needs the misc leaf")
        misc = np.ascontiguousarray(misc_np, np.int16)
        misc_ptr, misc_cols = misc.ctypes.data, misc.shape[1]
    else:
        misc = None
        misc_ptr, misc_cols = None, 0
    base = None if doc_base is None else \
        np.ascontiguousarray(doc_base, np.int32)
    sentinel_src = int(I8_NOT_REMOVED) if i8 else int(I16_NOT_REMOVED)
    rc = lib.oppack_widen(
        src, D, S, R_src, R_canon, misc_ptr, misc_cols, desc,
        None if base is None else base.ctypes.data,
        sentinel_src, int(NOT_REMOVED), dst,
    )
    if rc != 0:
        raise ValueError("oppack_widen: malformed narrow export")
    return dst


def widen_export(export_np,
                 doc_base: Optional[np.ndarray],
                 ob_rows: bool = True, ov_rows: bool = True,
                 i8: bool = False,
                 n_props: Optional[int] = None,
                 props_rows: bool = True) -> np.ndarray:
    """Undo the export transfer transforms on the host, always returning
    the canonical full int32 layout: unpack int8 pairs and stitch the misc
    leaf back into a row (``i8``; needs ``n_props``, the padded props
    width), widen int16 to int32, restore NOT_REMOVED, re-add per-document
    arena bases on live slots, and reinsert elided obliterate / overlap /
    props rows with their fills.  int32 full-layout buffers pass through
    untouched."""
    misc_np = None
    if isinstance(export_np, tuple):
        export_np, misc_np = export_np
    fields = _export_fields(ob_rows, ov_rows)
    if export_np.dtype == np.int32:
        out = export_np
    else:
        if i8:
            if n_props is None or misc_np is None:
                raise ValueError("an i8 widen needs the props width and "
                                 "the misc leaf")
            u = export_np.astype(np.uint16)
            n_bytes = len(fields) - 1 + (n_props if props_rows else 0)
            rows = [export_np[:, 0, :].astype(np.int32)]
            for i in range(n_bytes):
                pair = u[:, 1 + i // 2, :]
                half = (pair >> 8) if i % 2 == 0 else (pair & 0xFF)
                rows.append(half.astype(np.uint8).astype(np.int8)
                            .astype(np.int32))
            D, _R, S = export_np.shape
            misc_row = np.zeros((D, S), np.int32)
            misc_row[:, :misc_np.shape[1]] = misc_np
            rows.append(misc_row)
            out = np.stack(rows, axis=1)
        else:
            out = export_np.astype(np.int32)
        sentinel = int(I8_NOT_REMOVED) if i8 else int(I16_NOT_REMOVED)
        for f in SENTINEL_SEQ_FIELDS:
            if f not in fields:
                continue
            row = out[:, fields.index(f), :]
            row[row == sentinel] = NOT_REMOVED
        if doc_base is not None:
            # Re-add the per-doc arena base to live slots only (dead slots
            # were zeroed on the device and stay zero, as in int32).
            n = out[:, -1, 0]
            active = np.arange(out.shape[2])[None, :] < n[:, None]
            out[:, 0, :] += np.where(
                active, np.asarray(doc_base, np.int32)[:, None], 0)

    def reinsert(buf, fill_fields, split):
        D, _R, S = buf.shape
        filler = np.empty((D, len(fill_fields), S), np.int32)
        for i, f in enumerate(fill_fields):
            filler[:, i, :] = NOT_REMOVED if f.endswith("_seq") else -1
        return np.concatenate([buf[:, :split], filler, buf[:, split:]],
                              axis=1)

    if not props_rows:
        # Reinsert the constant PROP_ABSENT plane rows before the misc row.
        if n_props is None:
            raise ValueError("a props-row reinsert needs the props width")
        D, _R, S = out.shape
        filler = np.full((D, n_props, S), PROP_ABSENT, np.int32)
        out = np.concatenate([out[:, :-1], filler, out[:, -1:]], axis=1)
    if not ov_rows:
        out = reinsert(out, OV_SLOT_FIELDS,
                       fields.index("rem_client") + 1)  # rem2 slots next
    if not ob_rows:
        out = reinsert(out, OB_SLOT_FIELDS, len(NON_OB_SLOT_FIELDS))
    return out


def summaries_from_export(meta, export_np,
                          stats: Optional[dict] = None) -> List[SummaryTree]:
    """Canonical summaries for a whole chunk from its downloaded export,
    in any layout ``replay_export`` emits: widened first
    (``widen_export_native``, else ``widen_export``) to the int32 full
    layout, then bodies from the C++ extractor (one pass over the buffer)
    when liboppack is available, else the per-slot Python extraction;
    interval blobs and oracle-fallback docs take the host paths either
    way.  ``stats`` (optional dict) accumulates ``device_docs`` /
    ``fallback_docs`` counters — the true device-vs-oracle split."""
    from .interval_replay import FinalStateView, replay_intervals
    from .native_pack import extract_bodies

    docs = meta["docs"]
    D = len(docs)
    _i16, ob_rows_f, ov_rows_f, i8_f, props_rows_f = _export_flags(meta)
    widened = widen_export_native(
        export_np, meta.get("doc_base"), ob_rows_f, ov_rows_f, i8_f,
        meta.get("props_K"), props_rows_f)
    export_np = widened if widened is not None else widen_export(
        export_np, meta.get("doc_base"),
        ob_rows=ob_rows_f, ov_rows=ov_rows_f,
        i8=i8_f, n_props=meta.get("props_K"),
        props_rows=props_rows_f)
    state_np = state_dict_from_export(export_np)
    skip = np.zeros(D, np.uint8)
    for d in range(D):
        if meta["doc_packs"][d].needs_fallback or state_np["overflow"][d]:
            skip[d] = 1
    if stats is not None:
        n_skip = int(skip.sum())
        stats["fallback_docs"] = stats.get("fallback_docs", 0) + n_skip
        stats["device_docs"] = stats.get("device_docs", 0) + D - n_skip
    msn = np.asarray([doc.final_msn for doc in docs], np.int32)
    arena_text = meta["arena"].finalize()
    # Attribution docs take the Python record path below (their key blob
    # needs the pre-clamp seqs alongside the merge boundaries), so the
    # C++ pass must not extract their bodies just to discard them —
    # body_skip extends the fallback skip WITHOUT polluting the stats.
    body_skip = skip.copy()
    for d in range(D):
        if docs[d].attribution:
            body_skip[d] = 1
    bodies = extract_bodies(
        np.ascontiguousarray(export_np, np.int32), arena_text,
        [list(meta["doc_packs"][d].clients.values) for d in range(D)],
        meta["prop_keys"], list(meta["values"].values),
        msn, body_skip, int(NOT_REMOVED),
    )
    out: List[SummaryTree] = []
    live_len = state_np["live_len"]
    for d, doc in enumerate(docs):
        pack = meta["doc_packs"][d]
        if skip[d]:
            out.append(oracle_fallback_summary(doc))
            continue
        tree = SummaryTree()
        # Byte-equal to canonical_json({...}) (keys pre-sorted, minimal
        # separators).
        tree.add_blob(
            "header",
            b'{"length":%d,"minSeq":%d,"seq":%d}'
            % (int(live_len[d]), doc.final_msn, doc.final_seq),
        )
        if doc.attribution:
            # Attribution docs take the Python record path (pinned
            # bit-identical to the C++ bodies): the keys blob needs the
            # pre-clamp seqs alongside the merge boundaries.
            records, keys = _extract_records(meta, state_np, d,
                                             return_keys=True)
            tree.add_blob("body", canonical_json(records))
            if keys:
                tree.add_blob("attribution", canonical_json(keys))
        elif bodies is not None:
            tree.add_blob("body", bodies[d])
        else:
            tree.add_blob(
                "body", canonical_json(_extract_records(meta, state_np, d))
            )
        if pack.interval_ops or doc.base_intervals:
            view = FinalStateView(state_np, d, int(NOT_REMOVED))
            intervals = replay_intervals(
                view,
                pack.interval_ops,
                pack.client_idx,
                base_intervals=doc.base_intervals,
                base_seq=doc.base_seq,
            )
            if intervals:
                tree.add_blob("intervals", canonical_json(intervals))
        out.append(tree)
    return out


def replay_mergetree_batch(
    docs: Sequence[MergeTreeDocInput],
    stats: Optional[dict] = None,
    device="cuda",
) -> List[SummaryTree]:
    """Full pipeline: pack → narrow upload → device fold + export (one
    batch of every non-fallback document) → download → canonical
    summaries.

    Byte-identical to ``SharedString.summarize()`` after the oracle replays
    the same log.  ``stats`` accumulates ``device_docs`` /
    ``fallback_docs`` (pre-pack routing + post-fold overflow fallbacks).
    ``device`` defaults to the card; ``device="cpu"`` runs the plain fold.
    """
    from .batching import partition_replay

    dev = resolve_device(device)

    def fold_batch(batch):
        state, ops, meta = pack_mergetree_batch(batch)
        if not any(d.base_records for d in batch):
            # all-cold chunk: the initial state is built on the device
            export = replay_export(None, ops, meta, S=state.tstart.shape[1],
                                   device=dev)
        else:
            export = replay_export(state, ops, meta, device=dev)
        return summaries_from_export(meta, export_to_numpy(export),
                                     stats=stats)

    return partition_replay(
        docs, known_oracle_fallback, oracle_fallback_summary, fold_batch,
        stats=stats,
    )
