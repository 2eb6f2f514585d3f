"""SharedTree catch-up replay: the port of
``fluidframework_tpu/ops/tree_kernel.py``.

The oracle's sequenced-forest fold (``dds/tree.py`` ``apply_changeset``)
as array state plus an edit-fold.  Edits name node ids, not positions, so
every step is O(1) scatter work:

- the forest is a **doubly linked sibling list per container** (a
  container is one (parent node, field) pair, interned at pack time):
  ``head[C]``, ``next[N]``, ``prev[N]``, ``node_container[N]``;
- **insert** splices a chain materialized at pack time after its anchor;
- **remove** is a first-wins scatter into ``removed_seq``;
- **set** is a last-writer-wins scatter into ``value`` / ``value_seq``;
- **move** is detach + splice + seq restamp, behind a cycle test (is the
  destination inside the moved subtree?) by an ancestor walk of at most
  ``MAX_DEPTH`` steps.

Rare shapes take the oracle instead: revive edits, multi-id moves, and
walks deeper than ``MAX_DEPTH`` (the fold flags them as overflow).

The host half (packing, routing, extraction to canonical summaries) is a
copy of the reference's, numpy as there.  The device half is
``tree_fold_reference``, the plain PyTorch fold (vectorised over the
documents, a loop over the edit rows), and on the card the hand-written
kernel ``csrc/tree_fold.cu`` behind ``ops/tree_fold_cuda.py``, which
``replay_tree_batch`` calls.

**Index rules.**  The reference's fold reads and writes some planes at
``NIL = -1`` without a mask (the expiry of a NIL destination owner, the
head slot of an unlinked target's container, the gathers before a
``where``), and XLA gives those indices meaning: a read at a negative
index counts from the end and then clamps into the plane, a write does
the same count and is dropped outside the plane.  ``_read_index`` /
``_gather`` / ``_scatter`` are those rules, and the kernel keeps them bit
for bit, so every plane agrees with the reference's, padding rows too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..protocol.messages import SequencedMessage
from ..protocol.summary import SummaryTree, canonical_json
from .interning import Interner, next_bucket
from .mergetree_kernel import resolve_device

NOT_REMOVED = np.int32(np.iinfo(np.int32).max)
NO_VALUE = -1          # value column sentinel (interned ids are >= 0)
NIL = -1               # null node / container index

K_NOOP, K_INSERT, K_REMOVE, K_SET, K_MOVE = 0, 1, 2, 3, 4

#: Ancestor-walk budget for the move cycle test; deeper forests overflow
#: to the oracle path (never silently wrong).
MAX_DEPTH = 64

_NR = int(NOT_REMOVED)


class TreeState(NamedTuple):
    """Per-document forest planes (numpy on the host, tensors on a
    device), ``[D, C]`` / ``[D, N]`` int32 and ``overflow`` bool ``[D]``.
    ``container_parent`` is static (a container's owning node never
    changes; *nodes* move between containers)."""

    head: Any              # [D, C] first node idx of container / NIL
    next: Any              # [D, N]
    prev: Any              # [D, N]
    node_container: Any    # [D, N] current container / NIL (unlinked)
    container_parent: Any  # [D, C] owning node idx (0 = root) — static
    value: Any             # [D, N] interned value id / NO_VALUE
    value_seq: Any         # [D, N]
    insert_seq: Any        # [D, N] (restamped by moves)
    removed_seq: Any       # [D, N] NOT_REMOVED if alive
    overflow: Any          # [D] bool: ancestor walk exceeded budget


class TreeEdits(NamedTuple):
    """Packed edit stream, ``[D, T]`` int32, one row per flattened edit."""

    kind: Any       # K_NOOP pads the rows past a document's edits
    seq: Any
    container: Any  # destination container (insert/move)
    anchor: Any     # anchor node idx / NIL = field start
    first: Any      # block chain head (insert) / target (others)
    tail: Any       # block chain tail (insert; == first for move)
    value: Any      # interned value id (set)
    purge_msn: Any  # purge boundary when this edit applies: the max
    #                 min_seq over all PRIOR messages (+ base minSeq) — the
    #                 oracle pops expired tombstones exactly up to here
    #                 before applying this edit


#: the forest planes a suffix extension can add rows to, by axis
NODE_FIELDS = ("next", "prev", "node_container", "value", "value_seq",
               "insert_seq", "removed_seq")
CONT_FIELDS = ("head", "container_parent")


# ---------------------------------------------------------------------------
# Device half: the plain PyTorch edit-fold
# ---------------------------------------------------------------------------


def _read_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Where the reference reads ``plane[idx]``: a negative index counts
    from the end, then the index clamps into ``[0, n)``."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _gather(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``plane[d, idx[d]]`` for every document, by the read rule."""
    i = _read_index(idx, plane.shape[1]).long()[:, None]
    return plane.gather(1, i)[:, 0]


def _scatter(plane: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
             mask: torch.Tensor) -> None:
    """``plane[d, idx[d]] = val[d]`` in place where ``mask[d]``, by the
    write rule: a negative index counts from the end, and a write outside
    ``[0, n)`` is dropped."""
    n = plane.shape[1]
    i = torch.where(idx < 0, idx + n, idx)
    ok = mask & (i >= 0) & (i < n)
    i = i.clamp(0, n - 1).long()[:, None]
    keep = plane.gather(1, i)[:, 0]
    plane.scatter_(1, i, torch.where(ok, val, keep)[:, None])


def _splice_after(st: dict, mask, c, anchor, first, tail) -> None:
    """Link chain ``[first..tail]`` into container ``c`` after ``anchor``
    (or at the head when the anchor is NIL or not currently in ``c``, the
    oracle's fallback), for the documents in ``mask``; the reference's
    ``_splice_after``, its writes in its order (the last wins where
    indices alias)."""
    use = (anchor != NIL) & (_gather(st["node_container"], anchor) == c)
    old = torch.where(use, _gather(st["next"], anchor),
                      _gather(st["head"], c))
    _scatter(st["next"], tail, old, mask)
    _scatter(st["prev"], old, tail, mask & (old != NIL))
    _scatter(st["next"], anchor, first, mask & use)
    _scatter(st["prev"], first, torch.where(use, anchor, NIL), mask)
    _scatter(st["head"], c, first, mask & ~use)


def _in_subtree(st: dict, start, target, alive, work=None):
    """The reference's ``_in_subtree`` from ``start`` (the destination's
    owning node) for the documents ``alive`` at the outset: ``(hit,
    deep)``, where ``hit`` says the walk met ``target`` and ``deep`` that
    it was still going after ``MAX_DEPTH`` steps (the root not reached).
    A walk that stops stays stopped, so the loop ends once none goes on;
    ``work["walk_steps"]`` (when given) counts the steps walked, and
    ``work["doc_walk_steps"]`` each document's."""
    cur, hit = start, torch.zeros_like(alive)
    for _ in range(MAX_DEPTH):
        if not bool(alive.any()):
            break
        if work is not None:
            work["walk_steps"] += int(alive.sum())
            work["doc_walk_steps"] += alive.long()
        hit = hit | (alive & (cur == target))
        c = torch.where(alive & (cur != NIL),
                        _gather(st["node_container"], cur), NIL)
        cur = torch.where(c != NIL, _gather(st["container_parent"], c), NIL)
        alive = alive & (c != NIL)
    return hit, alive


def _apply_edit_row(st: dict, e: dict, work=None) -> None:
    """One edit row of every document, in place: the reference's
    ``_apply_edit``.  Its kinds exclude each other, so each kind's writes
    are masked to its documents, and every read of a kind sees that
    document's state before the row."""
    kind, seq, purge = e["kind"], e["seq"], e["purge_msn"]
    target = e["first"]
    removed = st["removed_seq"]

    def expired(idx):
        rs = _gather(removed, idx)
        return (rs != _NR) & (rs <= purge)

    # insert: an expired anchor falls back to the field start
    is_ins = kind == K_INSERT
    anchor = torch.where((e["anchor"] != NIL) & expired(e["anchor"]), NIL,
                         e["anchor"])
    _splice_after(st, is_ins, e["container"], anchor, target, e["tail"])
    # remove: the first remover wins the tombstone
    is_rem = kind == K_REMOVE
    _scatter(removed, target, seq, is_rem & (_gather(removed, target) == _NR))
    # set: last writer wins in fold order
    is_set = kind == K_SET
    _scatter(st["value"], target, e["value"], is_set)
    _scatter(st["value_seq"], target, seq, is_set)
    # move: cycle test and purge gates, detach, splice, restamp
    is_mov = kind == K_MOVE
    if not bool(is_mov.any()):
        return
    owner = _gather(st["container_parent"], e["container"])
    hit, deep = _in_subtree(st, owner, target, is_mov, work)
    do = is_mov & ~hit & ~expired(target) & ~expired(owner)
    anchor = torch.where(e["anchor"] == target, NIL, e["anchor"])
    anchor = torch.where((anchor != NIL) & expired(anchor), NIL, anchor)
    p, nx = _gather(st["prev"], target), _gather(st["next"], target)
    c_old = _gather(st["node_container"], target)
    _scatter(st["head"], c_old, nx, do & (p == NIL))
    _scatter(st["next"], p, nx, do & (p != NIL))
    _scatter(st["prev"], nx, p, do & (nx != NIL))
    _splice_after(st, do, e["container"], anchor, target, target)
    _scatter(st["node_container"], target, e["container"], do)
    _scatter(st["insert_seq"], target, seq, do)
    st["overflow"] |= is_mov & deep


def tree_fold_reference(state: TreeState, edits: TreeEdits,
                        work: Optional[dict] = None) -> TreeState:
    """The plain edit-fold: every document's edit rows applied in order to
    a copy of its state (the inputs are not written), bit for bit the
    reference's ``replay_vmapped`` on every plane, padding rows included.
    Tensors in, tensors out, on their device.  ``work`` (a dict, when
    given) gets ``walk_steps``, the ancestor-walk steps these inputs took,
    for a measurement's operation count, and ``doc_walk_steps``, each
    document's (int64 ``[D]``)."""
    st = {f: x.clone() for f, x in state._asdict().items()}
    if work is not None:
        work.setdefault("walk_steps", 0)
        work.setdefault("doc_walk_steps", torch.zeros(
            state.next.shape[0], dtype=torch.long, device=state.next.device))
    T = edits.kind.shape[1]
    for t in range(T):
        _apply_edit_row(st, {f: x[:, t] for f, x in edits._asdict().items()},
                        work)
    return TreeState(**st)


# ---------------------------------------------------------------------------
# Host side: packing and canonical summary extraction
# ---------------------------------------------------------------------------


@dataclass
class TreeDocInput:
    """One document's catch-up work item: optional base summary + op tail."""

    doc_id: str
    ops: Sequence[SequencedMessage]   # tree changeset messages, ascending seq
    base_summary: Optional[SummaryTree] = None
    final_seq: int = 0
    final_msn: int = 0
    #: attribution-enabled document (SURVEY §1 layer 8): the summary gains
    #: an "attribution" blob of pre-clamp (insert, value) seqs per emitted
    #: node.  The device state carries raw seqs — clamping is host-side —
    #: and the pack restores a warm base's keys, so this is extraction
    #: work only.
    attribution: bool = False
    #: catch-up cache identity (tiers 0/2/2.5, same contract as
    #: ``MergeTreeDocInput.cache_token``): ``(storage epoch, channel id,
    #: base ref_seq, base summary digest)`` — within one storage
    #: generation the edit stream extends append-only under this anchor.
    #: None bypasses every cache tier.
    cache_token: Optional[tuple] = None
    #: the messages as binary edit records with their doc-local tables
    #: (``ops/tree_native.encode_tree_ops``), written once at ingestion.
    #: When set the records are authoritative and ``ops`` may be empty: a
    #: batch of such documents with no base summary packs in C++
    #: (``tree_native.pack_records``), and the records decode back to the
    #: messages wherever the messages themselves are needed.  Such
    #: documents bypass the pack tiers, as binary string streams do.
    records: Optional[Any] = None


def tree_messages(doc: TreeDocInput) -> Sequence[SequencedMessage]:
    """The document's messages: ``ops``, or its records decoded."""
    if doc.records is None:
        return doc.ops
    from .tree_native import decode_tree_ops

    return decode_tree_ops(doc.records)


class _DocPack:
    """Per-document host bookkeeping: node/container interning plus the
    static attributes the device never needs (ids, types), and the purge
    bookkeeping (``removal_time``/``boundary``) the suffix extension
    resumes from."""

    def __init__(self) -> None:
        self.node_ids = Interner()     # node id str -> node idx
        self.node_types: List[str] = []
        self.containers = Interner()   # (node idx, field) -> container idx
        self.fallback_reason: Optional[str] = None
        self.header_seq = 0            # channel fold position for the header
        self.base_min_seq = 0
        #: host-exact removal times (first remover wins; base tombstones
        #: count) — they decide, per edit, whether the oracle had already
        #: popped a referenced node when the edit applied.
        self.removal_time: Dict[str, int] = {}
        #: purge boundary while applying the NEXT message = max min_seq
        #: over all prior messages (+ the base minSeq).
        self.boundary = 0
        self.node_ids.intern("")       # root is node 0
        self.node_types.append("")

    @property
    def needs_fallback(self) -> bool:
        return self.fallback_reason is not None

    def mark_fallback(self, reason: str) -> None:
        """First reason wins (it names the edit that disqualified the
        doc); later shapes would have routed through the oracle anyway."""
        if self.fallback_reason is None:
            self.fallback_reason = reason

    def node(self, node_id: str) -> int:
        idx = self.node_ids.intern(node_id)
        while len(self.node_types) <= idx:
            self.node_types.append("")
        return idx

    def container(self, parent_idx: int, field_name: str) -> int:
        return self.containers.intern((parent_idx, field_name))


class _RecordDocPack(_DocPack):
    """A document's bookkeeping as the native pack leaves it
    (``tree_native.pack_records`` sets every table); ``removal_time``,
    which only a suffix extension reads, is read from the records on
    first use."""

    def __init__(self, records) -> None:
        self._records = records

    def __getattr__(self, name):
        if name != "removal_time":
            raise AttributeError(name)
        from .tree_native import removal_times

        self.removal_time = removal_times(self._records)
        return self.removal_time


def _count_nodes_and_edits(doc: TreeDocInput) -> Tuple[int, int]:
    from ..dds.tree import content_ids

    nodes, edits = 1, 0  # root
    if doc.records is not None:
        nodes, edits = doc.records.n_nodes_est, doc.records.n_edits_est
    if doc.base_summary is not None:
        import json

        obj = json.loads(doc.base_summary.blob_bytes("header"))

        def count(o):
            return 1 + sum(
                count(ch)
                for chs in o.get("fields", {}).values() for ch in chs
            )

        nodes += sum(
            count(ch)
            for chs in obj.get("fields", {}).values() for ch in chs
        )
    if doc.records is not None:
        return nodes, edits
    for msg in doc.ops:
        for edit in msg.contents["edits"]:
            kind = edit["kind"]
            if kind == "insert":
                nodes += sum(len(content_ids(s)) for s in edit["content"])
                edits += 1
            elif kind in ("remove", "move"):
                edits += len(edit["ids"])
            elif kind == "revive":
                nodes += sum(len(content_ids(s)) for s in edit["content"])
                edits += len(edit["ids"])
            else:
                edits += 1
    return nodes, edits


def _materialize_spec(pack: _DocPack, values: Interner, node_rows: Dict,
                      chains: Dict, spec: dict, container: int) -> int:
    """Intern one NodeSpec subtree into host rows: the node row (value /
    seqs / tombstone), its nested containers, and their ordered chains.
    THE one materialization shared by the fresh pack and the tier-2
    suffix extension."""
    idx = pack.node(spec["id"])
    pack.node_types[idx] = spec["type"]
    node_rows[idx] = {
        "container": container,
        "value": (
            values.intern(spec["value"])
            if "value" in spec and spec["value"] is not None
            else NO_VALUE
        ),
        "value_seq": 0,
        "insert_seq": 0,
        "removed_seq": (
            spec["removedSeq"] if "removedSeq" in spec
            else int(NOT_REMOVED)
        ),
    }
    for f, children in spec.get("fields", {}).items():
        c = pack.container(idx, f)
        for ch in children:
            chains.setdefault(c, []).append(
                _materialize_spec(pack, values, node_rows, chains, ch, c))
    return idx


def _note_removals(removal_time: Dict[str, int], spec: dict) -> None:
    if spec.get("removedSeq") is not None:
        removal_time[spec["id"]] = spec["removedSeq"]
    for chs in spec.get("fields", {}).values():
        for ch in chs:
            _note_removals(removal_time, ch)


def fill_tree_doc_messages(pack: _DocPack, values: Interner,
                           node_rows: Dict, chains: Dict,
                           edit_rows: List[dict],
                           msgs: Sequence[SequencedMessage]) -> None:
    """THE per-message edit-row fill shared by ``pack_tree_batch`` and
    the pack cache's suffix extension (ops/tree_pipeline.py) — byte
    drift between fresh and suffix-extended packs is impossible by
    construction.  Resumes from (and advances) ``pack.removal_time`` /
    ``pack.boundary`` / ``pack.header_seq`` / ``pack.base_min_seq``, so
    filling a suffix continues exactly where the cached window stopped."""
    for msg in msgs:
        for edit in msg.contents["edits"]:
            if edit["kind"] == "remove":
                for nid in edit["ids"]:
                    # First remover wins; a FUTURE removal can never
                    # satisfy ``rt <= boundary`` below (its seq exceeds
                    # every prior min_seq), so pre-noting the whole span
                    # is equivalent to noting incrementally.
                    pack.removal_time.setdefault(nid, msg.seq)

    def popped(node_id: str) -> bool:
        rt = pack.removal_time.get(node_id)
        return rt is not None and rt <= pack.boundary

    for msg in msgs:
        pack.header_seq = max(pack.header_seq, msg.seq)
        pack.base_min_seq = max(pack.base_min_seq, msg.min_seq)
        rows_before = len(edit_rows)
        for edit in msg.contents["edits"]:
            kind = edit["kind"]
            if kind == "insert":
                if popped(edit["parent"]):
                    # The oracle skips this insert entirely (parent
                    # popped); follow-on references to its content
                    # would need an existence simulation — fallback.
                    pack.mark_fallback("purged_parent_insert")
                parent_idx = pack.node(edit["parent"])
                c = pack.container(parent_idx, edit["field"])
                block: List[int] = []
                for spec in edit["content"]:
                    idx = _materialize_spec(pack, values, node_rows,
                                            chains, spec, c)
                    node_rows[idx]["insert_seq"] = msg.seq
                    node_rows[idx]["value_seq"] = max(msg.seq, 0)
                    block.append(idx)
                # Nested nodes' seqs:
                def stamp(spec):
                    i = pack.node(spec["id"])
                    node_rows[i]["insert_seq"] = msg.seq
                    if node_rows[i]["value"] != NO_VALUE:
                        node_rows[i]["value_seq"] = msg.seq
                    for chs in spec.get("fields", {}).values():
                        for ch in chs:
                            stamp(ch)
                for spec in edit["content"]:
                    stamp(spec)
                anchor = edit["anchor"]
                edit_rows.append({
                    "kind": K_INSERT, "seq": msg.seq, "container": c,
                    "anchor": (
                        pack.node(anchor) if anchor is not None else NIL
                    ),
                    "first": block[0], "tail": block[-1],
                    "block": block,
                })
            elif kind == "remove":
                for nid in edit["ids"]:
                    edit_rows.append({
                        "kind": K_REMOVE, "seq": msg.seq,
                        "first": pack.node(nid),
                    })
            elif kind == "set":
                edit_rows.append({
                    "kind": K_SET, "seq": msg.seq,
                    "first": pack.node(edit["id"]),
                    "value": (
                        values.intern(edit["value"])
                        if edit["value"] is not None else NO_VALUE
                    ),
                })
            elif kind == "move":
                if len(edit["ids"]) != 1:
                    pack.mark_fallback("multi_id_move")  # block-cycle rules
                    continue
                parent_idx = pack.node(edit["parent"])
                c = pack.container(parent_idx, edit["field"])
                anchor = edit["anchor"]
                tgt = pack.node(edit["ids"][0])
                edit_rows.append({
                    "kind": K_MOVE, "seq": msg.seq, "container": c,
                    "anchor": (
                        pack.node(anchor) if anchor is not None else NIL
                    ),
                    "first": tgt, "tail": tgt,
                })
            elif kind == "revive":
                pack.mark_fallback("revive")  # purge-timing interaction
            else:
                raise ValueError(f"unknown edit kind {kind!r}")
        for row in edit_rows[rows_before:]:
            row["purge_msn"] = pack.boundary
        pack.boundary = max(pack.boundary, msg.min_seq)


def load_tree_base(pack: _DocPack, values: Interner, node_rows: Dict,
                   chains: Dict, doc: TreeDocInput) -> None:
    """Materialize a warm base summary into host rows (header seqs,
    tombstone times, attribution-key restore) — the pre-message half of
    the per-doc pack."""
    import json

    if doc.base_summary is None:
        return
    base_obj = obj = json.loads(doc.base_summary.blob_bytes("header"))
    pack.header_seq = obj.get("seq", 0)
    pack.base_min_seq = obj.get("minSeq", 0)
    pack.boundary = pack.base_min_seq
    if obj.get("limbo"):
        # Detached-but-rescuable subtrees in the base need a
        # container-less representation — oracle fallback.
        pack.mark_fallback("base_limbo")
    for f, children in obj.get("fields", {}).items():
        c = pack.container(0, f)
        for ch in children:
            idx = _materialize_spec(pack, values, node_rows, chains, ch, c)
            chains.setdefault(c, []).append(idx)
            node_rows[idx]["insert_seq"] = ch["insertSeq"]
    # insert/value seqs for nested nodes come from the summary obj.
    def fix_seqs(o):
        idx = pack.node(o["id"])
        node_rows[idx]["insert_seq"] = o["insertSeq"]
        node_rows[idx]["value_seq"] = o.get("valueSeq", 0)
        for chs in o.get("fields", {}).values():
            for ch in chs:
                fix_seqs(ch)
    for chs in obj.get("fields", {}).values():
        for ch in chs:
            fix_seqs(ch)
    if "attribution" in doc.base_summary.children:
        # Warm base carrying pre-clamp keys: restore them via the
        # ONE shared helper (SharedTree.load uses it too), so
        # re-summarizing regenerates identical keys.
        from ..dds.tree import restore_attribution_seqs

        def get_seqs(nid):
            if nid not in pack.node_ids:
                return None
            row = node_rows.get(pack.node(nid))
            return None if row is None else (
                row["insert_seq"], row["value_seq"])

        def put_seqs(nid, ins, val):
            row = node_rows[pack.node(nid)]
            row["insert_seq"], row["value_seq"] = ins, val

        restore_attribution_seqs(
            json.loads(
                doc.base_summary.blob_bytes("attribution")),
            get_seqs, put_seqs,
        )
    for chs in base_obj.get("fields", {}).values():
        for ch in chs:
            _note_removals(pack.removal_time, ch)


def scatter_tree_doc_rows(st: dict, ed: dict, d: int, node_rows: Dict,
                          chains: Dict, edit_rows: List[dict],
                          containers: List[tuple], t_base: int = 0,
                          cont_start: int = 0) -> None:
    """Write one document's host rows into the batch arrays (dicts of
    numpy planes).  THE one scatter shared by the fresh pack (``t_base``
    / ``cont_start`` 0) and the suffix extension (which scatters ONLY
    the new rows into copied planes: edit rows land at ``t_base``+,
    container rows from ``cont_start``)."""
    for c in range(cont_start, len(containers)):
        st["container_parent"][d, c] = containers[c][0]
    for idx, row in node_rows.items():
        st["node_container"][d, idx] = row["container"]
        st["value"][d, idx] = row["value"]
        st["value_seq"][d, idx] = row["value_seq"]
        st["insert_seq"][d, idx] = row["insert_seq"]
        st["removed_seq"][d, idx] = row["removed_seq"]
    # Pre-link chains: base-summary sibling lists fully; insert-block
    # interiors (head/prev of the block come alive at splice time).
    for e in edit_rows:
        if e["kind"] == K_INSERT:
            block = e["block"]
            for a, b in zip(block, block[1:]):
                st["next"][d, a] = b
                st["prev"][d, b] = a
    for c, members in chains.items():
        # Base lists (live at t=0) need head set; nested insert-block
        # chains were added under their materialized parent and are
        # reachable only through it, so setting head is safe for both —
        # an unreachable container's head is never read before its
        # parent links in.
        st["head"][d, c] = members[0]
        for a, b in zip(members, members[1:]):
            st["next"][d, a] = b
            st["prev"][d, b] = a
    for t, e in enumerate(edit_rows):
        ed["kind"][d, t_base + t] = e["kind"]
        ed["seq"][d, t_base + t] = e["seq"]
        ed["container"][d, t_base + t] = e.get("container", 0)
        ed["anchor"][d, t_base + t] = e.get("anchor", NIL)
        ed["first"][d, t_base + t] = e["first"]
        ed["tail"][d, t_base + t] = e.get("tail", e["first"])
        ed["value"][d, t_base + t] = e.get("value", NO_VALUE)
        ed["purge_msn"][d, t_base + t] = e.get("purge_msn", -1)


def empty_tree_arrays(D: int, N: int, C: int, T: int):
    """Fresh default-filled batch planes — also what the suffix
    extension's unwritten new rows must equal (inert interned rows keep
    these defaults)."""
    st = {
        "head": np.full((D, C), NIL, np.int32),
        "next": np.full((D, N), NIL, np.int32),
        "prev": np.full((D, N), NIL, np.int32),
        "node_container": np.full((D, N), NIL, np.int32),
        "container_parent": np.full((D, C), NIL, np.int32),
        "value": np.full((D, N), NO_VALUE, np.int32),
        "value_seq": np.zeros((D, N), np.int32),
        "insert_seq": np.zeros((D, N), np.int32),
        "removed_seq": np.full((D, N), NOT_REMOVED, np.int32),
        "overflow": np.zeros((D,), np.bool_),
    }
    ed = {
        "kind": np.zeros((D, T), np.int32),
        "seq": np.zeros((D, T), np.int32),
        "container": np.zeros((D, T), np.int32),
        "anchor": np.full((D, T), NIL, np.int32),
        "first": np.zeros((D, T), np.int32),
        "tail": np.zeros((D, T), np.int32),
        "value": np.full((D, T), NO_VALUE, np.int32),
        "purge_msn": np.full((D, T), -1, np.int32),
    }
    return st, ed


def tree_buckets(docs: Sequence[TreeDocInput]):
    """(N, T) sizing buckets from the estimate predicate.  +2·edits
    slack on N: anchors/parents naming already-purged ids intern fresh
    (inert) rows — the oracle's "missing → field start / drop" fallback
    falls out of their NIL containers.  ONE derivation point: the
    suffix extension re-evaluates this same predicate over the combined
    windows to decide whether the cached buckets still hold."""
    sizes = [_count_nodes_and_edits(d) for d in docs]
    N = next_bucket(
        max((n + 2 * e for n, e in sizes), default=1), floor=16
    )
    T = next_bucket(max((e for _, e in sizes), default=1), floor=16)
    return N, T


def _record_route(docs: Sequence[TreeDocInput]) -> bool:
    """Whether the native record pack takes ``docs``: every document
    carries records and no base summary."""
    return bool(docs) and all(
        d.records is not None and d.base_summary is None for d in docs)


def slice_tree_pack(docs: Sequence[TreeDocInput], k: int):
    """``pack_tree_batch``'s native route for ``docs`` cut into ``k``
    document ranges (a ``tree_native.RecordPack``, no step run yet), or
    None where that route does not take them: the same planes and meta,
    bit for bit."""
    from .tree_native import RecordPack, load_library

    lib = load_library() if _record_route(docs) else None
    if lib is None:
        return None
    N, T = tree_buckets(docs)
    return RecordPack(lib, docs, N, T, k)


def pack_tree_batch(docs: Sequence[TreeDocInput]):
    """Pack documents into uniform-shape arrays + host metadata.  A batch
    whose documents all carry records and no base summary packs natively
    (``tree_native.pack_records``: the same planes and meta, bit for bit,
    and ``meta["native_docs"]``); without the native library, or for any
    other batch, the pack below runs on the documents' messages.  Either
    meta holds ``value_json``, the value table as the native summary
    writer reads it (``tree_native.value_table``)."""
    from .tree_native import pack_records, value_table

    N, T = tree_buckets(docs)
    if _record_route(docs):
        packed = pack_records(docs, N, T)
        if packed is not None:
            return packed
    values = Interner()
    doc_packs = [_DocPack() for _ in docs]
    D = len(docs)
    # Containers ≤ nodes·fields; sized after a packing dry run is overkill —
    # intern first, then allocate.  Two passes keep the arrays exact.

    packed_docs = []
    for d, doc in enumerate(docs):
        pack = doc_packs[d]
        node_rows: Dict[int, dict] = {}
        chains: Dict[int, List[int]] = {}  # container -> ordered node idxs
        edit_rows: List[dict] = []
        load_tree_base(pack, values, node_rows, chains, doc)
        fill_tree_doc_messages(pack, values, node_rows, chains, edit_rows,
                               tree_messages(doc))
        packed_docs.append((node_rows, chains, edit_rows))

    C = next_bucket(
        max((len(p.containers) for p in doc_packs), default=1), floor=8
    )
    st, ed = empty_tree_arrays(D, N, C, T)
    for d, (node_rows, chains, edit_rows) in enumerate(packed_docs):
        scatter_tree_doc_rows(st, ed, d, node_rows, chains, edit_rows,
                              doc_packs[d].containers.values)

    meta = {
        "doc_packs": doc_packs, "values": values, "docs": docs,
        # Per-doc used-row counts: the digest mask (only written rows may
        # hash) and the suffix extension/splice windows read these.
        "n_nodes": np.asarray([len(p.node_ids) for p in doc_packs],
                              np.int32),
        "n_cont": np.asarray([len(p.containers) for p in doc_packs],
                             np.int32),
        "t_rows": np.asarray([len(rows) for _n, _c, rows in packed_docs],
                             np.int32),
        "value_json": value_table(values),
    }
    return TreeState(**st), TreeEdits(**ed), meta


class _ChainCycleError(Exception):
    """A sibling chain longer than the doc's interned rows: a cycle in
    the final linked list, reachable only through out-of-contract input
    (duplicate node ids) — extraction bails to the oracle."""


def oracle_fallback_summary(doc: TreeDocInput) -> SummaryTree:
    """Full oracle replay of one document — the exactness escape hatch."""
    from ..dds.tree import SharedTree

    replica = SharedTree(doc.doc_id)
    if doc.attribution:
        # Attribution-enabled docs must emit their keys blob on fallback
        # too (summarize keys on the flag alone).
        from ..runtime.attributor import Attributor

        replica._attributor = Attributor()
    if doc.base_summary is not None:
        replica.load(doc.base_summary)
    for msg in tree_messages(doc):
        replica.process(msg, local=False)
    replica.advance(doc.final_seq, doc.final_msn)
    return replica.summarize()


#: distinct-from-None sentinel: the memoized verdict itself can be None
_VERDICT_UNSET = object()


def known_tree_fallback(doc: TreeDocInput):
    # Memoized per doc object (same discipline as known_oracle_fallback):
    # benches and warm catch-up passes re-route the same doc objects, and
    # the base-header JSON parse + full op scan must not repeat per pass.
    cached = getattr(doc, "_fallback_verdict", _VERDICT_UNSET)
    if cached is not _VERDICT_UNSET:
        return cached
    verdict = _known_tree_fallback_uncached(doc)
    doc._fallback_verdict = verdict
    return verdict


def _known_tree_fallback_uncached(doc: TreeDocInput):
    """Pre-pack oracle routing: the reason string when the document's
    SHAPE disqualifies the device fold before packing — revive edits,
    multi-id moves, a base summary carrying limbo roots — else None.
    Mirrors the pack-time ``mark_fallback`` calls (MAX_DEPTH overflow
    and purged-parent inserts need the fold/purge simulation and stay
    post-pack); routing these out FIRST keeps them from inflating the
    shared N/T buckets, exactly like ``known_oracle_fallback`` does for
    merge-tree docs."""
    if doc.base_summary is not None:
        import json

        if json.loads(doc.base_summary.blob_bytes("header")).get("limbo"):
            return "base_limbo"
    if doc.records is not None:
        from .tree_native import route_records

        return route_records(doc.records)
    for msg in doc.ops:
        for edit in msg.contents["edits"]:
            kind = edit["kind"]
            if kind == "revive":
                return "revive"
            if kind == "move" and len(edit["ids"]) != 1:
                return "multi_id_move"
    return None


def summary_from_state(meta, state_np: dict, d: int,
                       stats: Optional[dict] = None,
                       counts: Optional[dict] = None) -> SummaryTree:
    """Final device state → the oracle's canonical summary bytes.
    ``stats`` counts this doc as device/fallback WHERE the routing
    decision is made — per REASON (revive / multi-id move / MAX_DEPTH
    overflow / …) through the shared ``count_fallback`` — so the
    counters can never drift from the actual serving path.  ``counts``
    (when given) gets ``extract_nodes``: the forest nodes this extraction
    wrote into the summary (none on the oracle's route)."""
    from .batching import count_fallback

    doc: TreeDocInput = meta["docs"][d]
    pack: _DocPack = meta["doc_packs"][d]
    if pack.needs_fallback or bool(state_np["overflow"][d]):
        count_fallback(stats, pack.fallback_reason or "max_depth")
        return oracle_fallback_summary(doc)
    values: Interner = meta["values"]
    msn = max(doc.final_msn, pack.base_min_seq)

    # containers by owning node, in interning order (which preserves field
    # name order only per first appearance — re-sort by field name to match
    # the oracle's sorted(fields) serialization).
    by_node: Dict[int, List[Tuple[str, int]]] = {}
    for (pidx, fname), c in zip(pack.containers.values,
                                range(len(pack.containers))):
        by_node.setdefault(pidx, []).append((fname, c))

    head = state_np["head"][d]
    nxt = state_np["next"][d]
    removed = state_np["removed_seq"][d]
    ins_seq = state_np["insert_seq"][d]
    val = state_np["value"][d]
    val_seq = state_np["value_seq"][d]
    node_container = state_np["node_container"][d]

    def keep(idx: int) -> bool:
        rs = int(removed[idx])
        return not (rs != int(NOT_REMOVED) and rs <= msn)

    n_used = len(pack.node_ids)

    def chain(c: int) -> List[int]:
        out = []
        cur = int(head[c])
        while cur != NIL:
            # Only nodes currently linked in this container (a node moved
            # away leaves no stale link — splice repairs both sides).
            if len(out) >= n_used:
                # More links than interned rows proves a CYCLE — possible
                # only on out-of-contract streams (e.g. duplicate node
                # ids).  The walk must terminate regardless; the doc
                # routes to the oracle below.
                raise _ChainCycleError()
            out.append(cur)
            cur = int(nxt[cur])
        return out

    emitted_nodes = 0

    def node_obj(idx: int) -> dict:
        nonlocal emitted_nodes
        emitted_nodes += 1
        obj: Dict[str, Any] = {
            "id": pack.node_ids.values[idx],
            "type": pack.node_types[idx],
            "insertSeq": 0 if int(ins_seq[idx]) <= msn else int(ins_seq[idx]),
        }
        v = int(val[idx])
        if v != NO_VALUE:
            obj["value"] = values.lookup(v)
            vs = int(val_seq[idx])
            obj["valueSeq"] = 0 if vs <= msn else vs
        rs = int(removed[idx])
        if rs != int(NOT_REMOVED):
            obj["removedSeq"] = rs
        fields = fields_obj(idx)
        if fields:
            obj["fields"] = fields
        return obj

    def fields_obj(idx: int) -> dict:
        out = {}
        for fname, c in sorted(by_node.get(idx, [])):
            kids = [node_obj(i) for i in chain(c) if keep(i)]
            if kids:
                out[fname] = kids
        return out

    try:
        root_obj = {
            "fields": fields_obj(0),
            "minSeq": msn,
            "seq": pack.header_seq,
        }
        # Limbo: kept nodes still linked in a chain whose owning node is
        # NOT kept (their enclosing tombstone expired).  The oracle
        # detaches them at purge time; here they surface at extraction —
        # same set, because rescued nodes were re-linked under kept
        # owners by their moves.  Unlinked rows (e.g. content of
        # oracle-skipped inserts, which are a pack-time fallback anyway)
        # are reachable from no chain.
        limbo_idxs = []
        for c in range(len(pack.containers)):
            owner = int(state_np["container_parent"][d][c])
            if owner == NIL or keep(owner):
                continue
            limbo_idxs.extend(i for i in chain(c) if keep(i))
        if limbo_idxs:
            limbo_idxs.sort(key=lambda i: pack.node_ids.values[i])
            root_obj["limbo"] = [node_obj(i) for i in limbo_idxs]
    except (_ChainCycleError, RecursionError):
        # A next-link or container-nesting cycle (out-of-contract input
        # such as duplicate node ids): extraction must never hang or
        # blow the stack — lose the device win, serve the oracle bytes.
        count_fallback(stats, "chain_cycle")
        return oracle_fallback_summary(doc)
    if stats is not None:
        stats["device_docs"] = stats.get("device_docs", 0) + 1
    if counts is not None:
        counts["extract_nodes"] = counts.get("extract_nodes", 0) \
            + emitted_nodes
    tree = SummaryTree()
    tree.add_blob("header", canonical_json(root_obj))
    if doc.attribution:
        # Mirror SharedTree.summarize's key emission: pre-clamp (insert,
        # value) seqs for every EMITTED node whose seq the header clamped
        # (the state rows are pre-clamp; node_obj clamps at emission).
        emitted: List[int] = []

        def collect(node_o: dict) -> None:
            emitted.append(pack.node(node_o["id"]))
            for children in node_o.get("fields", {}).values():
                for child in children:
                    collect(child)

        for children in root_obj.get("fields", {}).values():
            for child in children:
                collect(child)
        for spec in root_obj.get("limbo", []):
            collect(spec)
        keys = {
            pack.node_ids.values[i]: [int(ins_seq[i]), int(val_seq[i])]
            for i in emitted
            if 0 < int(ins_seq[i]) <= msn or 0 < int(val_seq[i]) <= msn
        }
        if keys:
            tree.add_blob("attribution", canonical_json(keys))
    return tree


def replay_tree_batch(docs: Sequence[TreeDocInput],
                      stats: Optional[dict] = None,
                      device="cuda") -> List[SummaryTree]:
    """Pack → edit-fold → canonical summaries, the reference's
    ``replay_tree_batch`` plus ``device``: the fold is
    ``tree_fold_cuda.fold``, the kernel on the card (the default) and the
    plain fold for ``device="cpu"``.

    Byte-identical to ``SharedTree.summarize()`` after the oracle replays
    the same log.  ``stats`` accumulates ``device_docs`` /
    ``fallback_docs`` (pack-time revive / multi-id-move detection + fold
    overflow, per reason).
    """
    from ..convert import tensors_to
    from .tree_fold_cuda import fold

    if not docs:
        return []
    dev = resolve_device(device)
    state, edits, meta = pack_tree_batch(docs)
    final = fold(tensors_to(state, dev), tensors_to(edits, dev))
    state_np = {k: v.cpu().numpy() for k, v in final._asdict().items()}
    return [summary_from_state(meta, state_np, d, stats=stats)
            for d in range(len(docs))]
