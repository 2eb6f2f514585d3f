"""SharedTree — the hierarchical-data merge engine.

Capability-equivalent of the reference's new-gen tree DDS (SURVEY.md §2.2:
``SharedTree``/``SharedTreeCore``/``EditManager``/``IForest``/changeset
compose/invert/rebase; upstream paths UNVERIFIED — empty reference mount).

Design (normative rules in SEMANTICS.md §tree).  Two deliberate departures
from the reference's architecture, both TPU-first:

1. **Id-addressed edits.**  Instead of the reference's field-kind changeset
   algebra (index-based OT with per-field mark lists), every node has a
   globally-unique author-assigned id and edits target ids: ``insert`` places
   a content block *after an anchor sibling id* (the author resolves
   index→anchor in their own view), ``remove``/``revive``/``move``/``set``
   name ids directly.  Sequenced application then needs no positional
   transformation at all — ops replay as pure scatters and linked-list
   splices, which is what lets the device kernel fold thousands of documents
   in parallel where index-OT would force a serial position walk per op.

2. **Sequenced forest + predicted view.**  The canonical state is the
   *sequenced forest*: a pure fold of sequenced changesets in total order,
   identical code for remote ops and the client's own acks — convergence is
   determinism of the fold, not delicacy of an overlay.  The user-facing
   optimistic view is a *prediction*: the sequenced forest copied and the
   client's pending changesets replayed on top, rebuilt lazily.  (The
   reference reaches the same split via EditManager trunk + local branch
   rebasing; here the local branch "rebase" is just replaying id-addressed
   edits, which never need rewriting.)

Tombstone discipline matches the merge-tree: removed nodes stay in sibling
lists until ``min_seq`` passes (zamboni), so anchors stay resolvable for
every op still in flight.  Concurrent inserts at one anchor stack
newest-first (the later-sequenced op applies later and lands immediately
after the anchor), the merge-tree rule.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

from ..protocol.messages import UNASSIGNED_SEQ, SequencedMessage
from ..protocol.summary import SummaryTree, canonical_json
from .shared_object import SharedObject

#: Anchor value meaning "at the start of the field".
FIELD_START = None

#: The hidden root node id; its fields are the document's root fields.
ROOT_ID = ""


def restore_attribution_seqs(keys: Dict[str, list], get_seqs,
                             put_seqs) -> None:
    """Warm-restore of pre-clamp (insert, value) seqs from a summary's
    "attribution" blob: fill ONLY zero seqs (the body already carried
    nonzero ones), skip unknown node ids.  ``get_seqs(nid)`` returns
    ``(ins, val)`` or None; ``put_seqs(nid, ins, val)`` writes back.

    THE single implementation shared by ``SharedTree.load`` and the
    catch-up service's warm-base pack (ops/tree_kernel.py) — byte parity
    across the CPU and device folds depends on these never diverging
    (review r5)."""
    for nid, (ins, val) in keys.items():
        cur = get_seqs(nid)
        if cur is None:
            continue
        cur_ins, cur_val = cur
        put_seqs(
            nid,
            ins if (ins and cur_ins == 0) else cur_ins,
            val if (val and cur_val == 0) else cur_val,
        )


# ---------------------------------------------------------------------------
# Schema (SchemaFactory-lite)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FieldSchema:
    """A field of an object node: ``kind`` is 'value' (node value payload) or
    'sequence' (ordered children restricted to the allowed types)."""

    kind: str                      # "value" | "sequence"
    allowed: Tuple[str, ...] = ()  # allowed child type names (sequence only)


class SchemaFactory:
    """Builds a named-type schema, capability parity with the reference's
    ``SchemaFactory``/``TreeViewConfiguration`` (SURVEY.md §2.2 tree)."""

    def __init__(self, scope: str = "") -> None:
        self.scope = scope
        self.types: Dict[str, Dict[str, FieldSchema]] = {}

    def _qualify(self, name: str) -> str:
        return f"{self.scope}.{name}" if self.scope else name

    def object(self, name: str, fields: Dict[str, FieldSchema]) -> str:
        qname = self._qualify(name)
        self.types[qname] = dict(fields)
        return qname

    def array(self, name: str, allowed: Tuple[str, ...]) -> str:
        return self.object(name, {"": FieldSchema("sequence", tuple(allowed))})

    @staticmethod
    def sequence(*allowed: str) -> FieldSchema:
        return FieldSchema("sequence", tuple(allowed))

    @staticmethod
    def value() -> FieldSchema:
        return FieldSchema("value")


@dataclasses.dataclass
class TreeViewConfiguration:
    """Root configuration: which types the root field admits."""

    schema: SchemaFactory
    root_allowed: Tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# Forest
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TreeNode:
    """One forest node."""

    id: str
    type: str
    value: Any = None
    value_seq: int = 0                 # seq of the value write (LWW record)
    insert_seq: int = 0                # seq stamped on insert (or last move)
    removed_seq: Optional[int] = None  # tombstone marker
    parent: Optional[Tuple[str, str]] = None  # (parent id, field name)
    fields: Dict[str, List[str]] = dataclasses.field(default_factory=dict)

    def visible(self) -> bool:
        return self.removed_seq is None


class Forest:
    """Id→node store.  Capability-equivalent of the reference's ``IForest``
    (object-forest); the chunked-forest capability (bulk array encoding) is
    what the device kernel's packed representation provides."""

    def __init__(self) -> None:
        self.nodes: Dict[str, TreeNode] = {}
        self.nodes[ROOT_ID] = TreeNode(id=ROOT_ID, type="")

    def copy(self) -> "Forest":
        out = Forest.__new__(Forest)
        out.nodes = {
            nid: dataclasses.replace(
                n, fields={f: list(s) for f, s in n.fields.items()}
            )
            for nid, n in self.nodes.items()
        }
        return out

    # -- queries ---------------------------------------------------------------

    def node(self, node_id: str) -> TreeNode:
        return self.nodes[node_id]

    def contains(self, node_id: str) -> bool:
        return node_id in self.nodes

    def visible_children(self, parent_id: str, field: str) -> List[str]:
        parent = self.nodes[parent_id]
        return [
            cid for cid in parent.fields.get(field, [])
            if self.nodes[cid].visible()
        ]

    def is_visible(self, node_id: str) -> bool:
        """Visible including ancestor removals."""
        if node_id == ROOT_ID:
            return True
        nid: Optional[str] = node_id
        while nid is not None and nid != ROOT_ID:
            n = self.nodes.get(nid)
            if n is None or not n.visible():
                return False
            nid = n.parent[0] if n.parent else None
        return nid == ROOT_ID

    def in_subtree(self, node_id: str, root_id: str) -> bool:
        nid: Optional[str] = node_id
        while nid is not None:
            if nid == root_id:
                return True
            n = self.nodes.get(nid)
            nid = n.parent[0] if n is not None and n.parent else None
        return False

    # -- structure edits -------------------------------------------------------

    def place_block(
        self, parent_id: str, field: str, anchor: Optional[str],
        ids: List[str],
    ) -> None:
        """Splice a block immediately after the anchor (or at field start).
        The op being applied is always the newest state in the fold, so
        same-anchor concurrent inserts stack newest-first automatically."""
        sibs = self.nodes[parent_id].fields.setdefault(field, [])
        if anchor is FIELD_START:
            pos = 0
        else:
            try:
                pos = sibs.index(anchor) + 1
            except ValueError:
                pos = 0  # anchor moved away/purged: deterministic fallback
        sibs[pos:pos] = ids

    def detach(self, node_id: str) -> None:
        n = self.nodes[node_id]
        if n.parent is None:
            return
        parent = self.nodes.get(n.parent[0])
        if parent is None:
            return
        sibs = parent.fields.get(n.parent[1], [])
        try:
            sibs.remove(node_id)
        except ValueError:
            pass

    def purge_expired(self, node_id: str, min_seq: int) -> None:
        """Pop this EXPIRED tombstone; descendants that are alive or still
        in-window become detached LIMBO roots (``parent=None``) — they stay
        addressable by id, because a later sequenced move can rescue a node
        that an earlier op relocated into the tombstone's subtree
        (id-addressed moves make this protocol-reachable; fuzz-found).
        Descendants that are themselves expired pop recursively."""
        n = self.nodes.pop(node_id, None)
        if n is None:
            return
        for _field, kids in list(n.fields.items()):
            for cid in list(kids):
                c = self.nodes.get(cid)
                if c is None:
                    continue
                if c.removed_seq is not None and c.removed_seq <= min_seq:
                    self.purge_expired(cid, min_seq)
                else:
                    c.parent = None  # limbo root

    def limbo_roots(self) -> List[str]:
        """Detached (rescuable) roots, sorted by id — the limbo section of
        summaries."""
        return sorted(
            nid for nid, n in self.nodes.items()
            if nid != ROOT_ID and n.parent is None
        )

    def purge_subtree(self, node_id: str) -> None:
        n = self.nodes.pop(node_id, None)
        if n is None:
            return
        for sibs in n.fields.values():
            for cid in sibs:
                self.purge_subtree(cid)


# ---------------------------------------------------------------------------
# Changeset algebra and the fold
# ---------------------------------------------------------------------------
#
# A changeset is {"edits": [edit, ...]}, edits applied in order.  Edit kinds:
#   insert : parent, field, anchor, content=[NodeSpec]
#   remove : ids=[...]                      (tombstone the nodes)
#   revive : ids, parent, field, anchor, content   (undo of remove)
#   set    : id, value, prev
#   move   : ids, parent, field, anchor, prev=[[id,parent,field,anchor],...]
#
# NodeSpec = {"id", "type", "value", "fields": {f: [NodeSpec]}}
#
# compose = concatenation (transactions squash to one changeset); invert is
# edit-wise reversal (SURVEY.md §3.4 rebaser capability — id-addressing means
# the sequenced-apply path needs no positional rebase, see module docstring).


def compose(changesets: List[dict]) -> dict:
    edits: List[dict] = []
    for cs in changesets:
        edits.extend(cs["edits"])
    return {"edits": edits}


def content_ids(spec: dict) -> List[str]:
    """All node ids in a NodeSpec subtree (pre-order)."""
    out = [spec["id"]]
    for children in spec.get("fields", {}).values():
        for child in children:
            out.extend(content_ids(child))
    return out


def node_spec(forest: Forest, node_id: str) -> dict:
    """Serialize a subtree to a NodeSpec (repair data / wire content).
    Tombstone markers ride along so repair-driven re-materialization does
    not resurrect descendants that were removed by *other* edits (their
    hidden-forever state must survive the purge/revive race)."""
    n = forest.node(node_id)
    spec: Dict[str, Any] = {"id": n.id, "type": n.type}
    if n.value is not None:
        spec["value"] = n.value
    if n.removed_seq is not None:
        spec["removedSeq"] = n.removed_seq
    fields = {
        f: [node_spec(forest, cid) for cid in sibs]
        for f, sibs in sorted(n.fields.items()) if sibs
    }
    if fields:
        spec["fields"] = fields
    return spec


def _location_of(forest: Forest, nid: str) -> Tuple[str, str, Optional[str]]:
    """(parent, field, previous-sibling anchor) of a node, for inverses."""
    n = forest.node(nid)
    pid, field = n.parent if n.parent else (ROOT_ID, "")
    sibs = forest.node(pid).fields.get(field, [])
    idx = sibs.index(nid)
    return pid, field, (sibs[idx - 1] if idx > 0 else FIELD_START)


def invert(changeset: dict, forest: Forest) -> dict:
    """Inverse changeset (for undo), computed against the state in which the
    changeset has applied.  Repair content for removes is captured from the
    forest, so the inverse is self-contained on the wire."""
    out: List[dict] = []
    for edit in reversed(changeset["edits"]):
        kind = edit["kind"]
        if kind == "insert":
            out.append({
                "kind": "remove",
                "ids": [spec["id"] for spec in edit["content"]],
            })
        elif kind == "remove":
            for nid in reversed(edit["ids"]):
                if not forest.contains(nid):
                    continue
                pid, field, anchor = _location_of(forest, nid)
                out.append({
                    "kind": "revive", "ids": [nid], "parent": pid,
                    "field": field, "anchor": anchor,
                    "content": [node_spec(forest, nid)],
                })
        elif kind == "revive":
            out.append({"kind": "remove", "ids": list(edit["ids"])})
        elif kind == "set":
            out.append({
                "kind": "set", "id": edit["id"],
                "value": edit.get("prev"), "prev": edit["value"],
            })
        elif kind == "move":
            for nid, pid, field, anchor in reversed(edit.get("prev", [])):
                if not forest.contains(nid):
                    continue
                back = [[nid, *_location_of(forest, nid)]]
                out.append({
                    "kind": "move", "ids": [nid], "parent": pid,
                    "field": field, "anchor": anchor, "prev": back,
                })
        else:
            raise ValueError(f"unknown edit kind {kind!r}")
    return {"edits": out}


def _materialize(
    forest: Forest, spec: dict, parent_id: str, field: str, seq: int,
) -> bool:
    """Create the spec'd subtree; returns False (creating nothing) when the
    id already exists — a node rescued out of a purged subtree keeps its
    current location ("move wins the location"), so revive repair data must
    not clone it."""
    if forest.contains(spec["id"]):
        return False
    n = TreeNode(
        id=spec["id"], type=spec["type"],
        value=spec.get("value"), value_seq=max(seq, 0),
        insert_seq=seq, removed_seq=spec.get("removedSeq"),
        parent=(parent_id, field),
    )
    forest.nodes[n.id] = n
    for f, children in spec.get("fields", {}).items():
        for child in children:
            if _materialize(forest, child, n.id, f, seq):
                n.fields.setdefault(f, []).append(child["id"])
    return True


def apply_changeset(forest: Forest, cs: dict, seq: int) -> None:
    """THE fold step: apply one changeset at sequence position ``seq``.

    Used identically for remote ops, the client's own acks, catch-up replay,
    and (with ``seq=UNASSIGNED_SEQ``) for predicting pending local ops onto a
    view copy.  Every rule here must be a pure function of (forest, cs, seq)
    — determinism of this function *is* the convergence guarantee, and the
    device kernel (ops.tree_kernel) reproduces it bit-for-bit.
    """
    for edit in cs["edits"]:
        kind = edit["kind"]
        if kind == "insert":
            parent_id = edit["parent"]
            if not forest.contains(parent_id):
                continue  # parent purged with an expired tombstone subtree
            anchor = edit["anchor"]
            prev = anchor if (
                anchor is FIELD_START or forest.contains(anchor)
            ) else FIELD_START
            created = [
                spec["id"] for spec in edit["content"]
                if _materialize(forest, spec, parent_id, edit["field"], seq)
            ]
            forest.place_block(parent_id, edit["field"], prev, created)
        elif kind == "remove":
            for nid in edit["ids"]:
                n = forest.nodes.get(nid)
                if n is not None and n.removed_seq is None:
                    n.removed_seq = seq  # first remover wins the tombstone
        elif kind == "revive":
            for nid in edit["ids"]:
                n = forest.nodes.get(nid)
                if n is not None:
                    n.removed_seq = None
                elif forest.contains(edit["parent"]):
                    # Tombstone already purged: re-insert from repair data.
                    # Descendants keep their own recorded tombstones; only
                    # the revive target itself comes back alive.
                    content = [c for c in edit["content"] if c["id"] == nid]
                    anchor = edit["anchor"]
                    if anchor is not FIELD_START and not forest.contains(
                        anchor
                    ):
                        anchor = FIELD_START
                    created = [
                        spec["id"] for spec in content
                        if _materialize(
                            forest, spec, edit["parent"], edit["field"], seq
                        )
                    ]
                    forest.place_block(
                        edit["parent"], edit["field"], anchor, created
                    )
                    forest.node(nid).removed_seq = None
        elif kind == "set":
            n = forest.nodes.get(edit["id"])
            if n is not None:
                n.value = edit["value"]
                n.value_seq = max(seq, n.value_seq)
        elif kind == "move":
            # Moves relocate alive nodes and tombstones alike ("remove wins
            # the removed state, move wins the location" — remove-by-id is
            # location-independent, so no positional conflict exists).
            ids = [nid for nid in edit["ids"] if forest.contains(nid)]
            if not ids or not forest.contains(edit["parent"]):
                continue
            if any(forest.in_subtree(edit["parent"], nid) for nid in ids):
                continue  # destination inside moved subtree: drop the move
            anchor = edit["anchor"]
            if anchor is not FIELD_START and (
                not forest.contains(anchor) or anchor in ids
            ):
                anchor = FIELD_START
            for nid in ids:
                forest.detach(nid)
            forest.place_block(edit["parent"], edit["field"], anchor, ids)
            for nid in ids:
                n = forest.node(nid)
                n.parent = (edit["parent"], edit["field"])
                n.insert_seq = seq
        else:
            raise ValueError(f"unknown edit kind {kind!r}")


# ---------------------------------------------------------------------------
# EditManager — trunk bookkeeping + collab-window eviction
# ---------------------------------------------------------------------------


class EditManager:
    """Trunk tail above the collaboration window (SURVEY.md §3.4: trunk
    eviction below minimumSequenceNumber).  With id-addressed edits the
    sequenced-apply path needs no trunk replay — the tail serves undo
    windows and introspection; eviction mirrors the collab-window GC."""

    def __init__(self) -> None:
        self.trunk: List[Tuple[int, Optional[str], dict]] = []
        self.evicted_below = 0

    def add_sequenced(self, seq: int, client: Optional[str], cs: dict) -> None:
        self.trunk.append((seq, client, cs))

    def evict(self, min_seq: int) -> None:
        keep = [(s, c, cs) for (s, c, cs) in self.trunk if s > min_seq]
        if len(keep) != len(self.trunk):
            self.trunk = keep
            self.evicted_below = max(self.evicted_below, min_seq)


# ---------------------------------------------------------------------------
# SharedTree
# ---------------------------------------------------------------------------


class SharedTree(SharedObject):
    """The tree DDS.  Public API mirrors the reference's simple-tree surface
    at the capability level: schema'd content, transactions, id-stable
    nodes, structural edits, LWW values, undo via inversion."""

    TYPE = "tree-tpu"
    REBASE_POSITION_FREE = True

    def __init__(
        self, object_id: str,
        config: Optional[TreeViewConfiguration] = None,
    ) -> None:
        super().__init__(object_id)
        self.seq_forest = Forest()
        self.edit_manager = EditManager()
        self.config = config
        self._id_counter = 0
        self._txn_edits: Optional[List[dict]] = None
        self._min_seq = 0
        self._last_seq = 0
        self._view_cache: Optional[Forest] = None

    # -- the predicted view ----------------------------------------------------

    @property
    def view(self) -> Forest:
        """Sequenced forest + pending local changesets replayed on top.
        Detached (never-connected) trees edit the sequenced forest directly
        through the same path: pending is always empty there because
        _submit_local_op drops ops pre-attach, so prediction == state."""
        pending = [entry[1] for entry in self._pending]
        if self._txn_edits:
            pending = pending + [{"edits": self._txn_edits}]
        if not pending:
            return self.seq_forest
        if self._view_cache is None:
            view = self.seq_forest.copy()
            for cs in pending:
                apply_changeset(view, cs, UNASSIGNED_SEQ)
            self._view_cache = view
        return self._view_cache

    def _invalidate(self) -> None:
        self._view_cache = None

    # -- ids -------------------------------------------------------------------

    def _next_id(self) -> str:
        self._id_counter += 1
        prefix = self.client_id if self.client_id else "init"
        return f"{prefix}-{self._id_counter}"

    # -- reads -----------------------------------------------------------------

    def children(self, parent_id: str = ROOT_ID, field: str = "") -> List[str]:
        return self.view.visible_children(parent_id, field)

    def value_of(self, node_id: str) -> Any:
        return self.view.node(node_id).value

    def type_of(self, node_id: str) -> str:
        return self.view.node(node_id).type

    def contains(self, node_id: str) -> bool:
        view = self.view
        return view.contains(node_id) and view.is_visible(node_id)

    def attribution_of(self, node_id: str,
                       kind: str = "insert") -> Optional[dict]:
        """Who created (``kind='insert'``, incl. last move) or last wrote
        the value of (``kind='value'``) a node, resolved through the
        container attributor (SURVEY §1 layer 8); None when detached,
        unattributed, or the stamp is still pending."""
        view = self.view
        if not view.contains(node_id):
            return None  # stale/garbage id or window-dropped subtree
        node = view.node(node_id)
        seq = node.insert_seq if kind == "insert" else node.value_seq
        return self._attribution(seq if seq > 0 else None)

    def to_obj(self, node_id: str = ROOT_ID) -> Any:
        """Nested plain-object view of the visible tree (tests/debugging)."""
        view = self.view
        return self._to_obj(view, node_id)

    def _to_obj(self, view: Forest, node_id: str) -> Any:
        n = view.node(node_id)
        fields = {
            f: [
                self._to_obj(view, cid)
                for cid in view.visible_children(node_id, f)
            ]
            for f in sorted(n.fields)
            if view.visible_children(node_id, f)
        }
        if node_id == ROOT_ID:
            return fields
        out: Dict[str, Any] = {"type": n.type}
        if n.value is not None:
            out["value"] = n.value
        if fields:
            out["fields"] = fields
        return out

    # -- schema ----------------------------------------------------------------

    def _check_schema(self, parent_id: str, field: str, specs: List[dict]):
        if self.config is None:
            return
        if parent_id == ROOT_ID:
            allowed = self.config.root_allowed
        else:
            ptype = self.view.node(parent_id).type
            fs = self._field_schema(ptype, field)
            if fs.kind != "sequence":
                raise ValueError(f"schema: field {field!r} is not a sequence")
            allowed = fs.allowed
        for spec in specs:
            if allowed and spec["type"] not in allowed:
                raise ValueError(
                    f"schema: type {spec['type']!r} not allowed here"
                )
            for f, children in spec.get("fields", {}).items():
                self._check_spec_field(spec["type"], f, children)

    def _field_schema(self, ptype: str, field: str) -> FieldSchema:
        fields = self.config.schema.types.get(ptype)
        if fields is None or field not in fields:
            raise ValueError(f"schema: type {ptype!r} has no field {field!r}")
        return fields[field]

    def _check_spec_field(self, ptype: str, field: str, specs: List[dict]):
        fs = self._field_schema(ptype, field)
        for spec in specs:
            if fs.allowed and spec["type"] not in fs.allowed:
                raise ValueError(
                    f"schema: type {spec['type']!r} not allowed in "
                    f"{ptype}.{field}"
                )
            for f, children in spec.get("fields", {}).items():
                self._check_spec_field(spec["type"], f, children)

    # -- content construction --------------------------------------------------

    def build(self, type_name: str, value: Any = None,
              fields: Optional[Dict[str, List[dict]]] = None) -> dict:
        """Build a NodeSpec with fresh ids (recursively)."""
        spec: Dict[str, Any] = {"id": self._next_id(), "type": type_name}
        if value is not None:
            spec["value"] = value
        if fields:
            spec["fields"] = {
                f: [self._ensure_ids(c) for c in children]
                for f, children in fields.items()
            }
        return spec

    def _ensure_ids(self, spec: dict) -> dict:
        spec = dict(spec)
        if "id" not in spec:
            spec["id"] = self._next_id()
        if spec.get("fields"):
            spec["fields"] = {
                f: [self._ensure_ids(c) for c in children]
                for f, children in spec["fields"].items()
            }
        return spec

    # -- edits (public API) ----------------------------------------------------

    def insert(self, parent_id: str, field: str, index: int,
               content: List[dict]) -> List[str]:
        """Insert NodeSpecs at a visible index; returns the new node ids."""
        if not self.contains(parent_id):
            raise KeyError(f"insert: parent {parent_id!r} not visible")
        content = [self._ensure_ids(c) for c in content]
        self._check_schema(parent_id, field, content)
        anchor = self._anchor_for_index(parent_id, field, index)
        self._do_edit({
            "kind": "insert", "parent": parent_id, "field": field,
            "anchor": anchor, "content": content,
        })
        return [c["id"] for c in content]

    def remove(self, *node_ids: str) -> None:
        for nid in node_ids:
            if not self.contains(nid):
                raise KeyError(f"remove: node {nid!r} not visible")
        self._do_edit({"kind": "remove", "ids": list(node_ids)})

    def remove_range(self, parent_id: str, field: str,
                     start: int, end: int) -> None:
        vis = self.view.visible_children(parent_id, field)
        self.remove(*vis[start:end])

    def set_value(self, node_id: str, value: Any) -> None:
        if not self.contains(node_id):
            raise KeyError(f"set_value: node {node_id!r} not visible")
        prev = self.view.node(node_id).value
        self._do_edit(
            {"kind": "set", "id": node_id, "value": value, "prev": prev}
        )

    def move(self, node_ids: List[str], parent_id: str, field: str,
             index: int) -> None:
        for nid in node_ids:
            if not self.contains(nid):
                raise KeyError(f"move: node {nid!r} not visible")
            if self.view.in_subtree(parent_id, nid):
                raise ValueError("move: destination inside moved subtree")
        anchor = self._anchor_for_index(
            parent_id, field, index, exclude=set(node_ids)
        )
        # Previous locations ride along so any replica can invert the move
        # (undo) without historical state.
        prev = [[nid, *_location_of(self.view, nid)] for nid in node_ids]
        self._do_edit({
            "kind": "move", "ids": list(node_ids), "parent": parent_id,
            "field": field, "anchor": anchor, "prev": prev,
        })

    def undo_changeset(self, cs: dict) -> dict:
        """Invert a changeset against the current sequenced state and submit
        the inverse as a fresh edit (the undo-redo building block)."""
        inverse = invert(cs, self.seq_forest)
        self._submit_changeset(inverse)
        return inverse

    def _anchor_for_index(
        self, parent_id: str, field: str, index: int,
        exclude: Optional[set] = None,
    ) -> Optional[str]:
        vis = self.view.visible_children(parent_id, field)
        if exclude:
            vis = [v for v in vis if v not in exclude]
        if index <= 0 or not vis:
            return FIELD_START
        return vis[min(index, len(vis)) - 1]

    # -- transactions ----------------------------------------------------------

    def transaction(self) -> "_Transaction":
        return _Transaction(self)

    def _do_edit(self, edit: dict) -> None:
        if self._txn_edits is not None:
            self._txn_edits.append(edit)
            self._invalidate()
        else:
            self._submit_changeset({"edits": [edit]})

    def _submit_changeset(self, cs: dict) -> None:
        if self.is_attached:
            self._submit_local_op(cs, local_metadata=cs)
            self._emit("changed", {"changeset": cs}, local=True)
        else:
            # Detached: the edit is immediately "sequenced" locally — the
            # attach summary will carry it (reference: attach serializes
            # initial state).
            apply_changeset(self.seq_forest, cs, seq=0)
        self._invalidate()

    def apply_stashed_op(self, contents) -> None:
        # Changesets are id-addressed: no positional rebase needed — re-apply
        # as a fresh local edit on the rehydrated state.
        self._submit_changeset(contents)

    # -- sequenced apply (SharedObject) ----------------------------------------

    def _process_core(self, msg: SequencedMessage, local: bool, meta) -> None:
        if msg.seq <= self._last_seq:
            return  # tail overlapping the loaded summary: already folded in
        # The recorded sequence point is the last op folded into THIS
        # channel (not container-wide messages), so the summary stays a
        # function of the channel's logical fold position.
        self._last_seq = msg.seq
        cs = msg.contents
        self.edit_manager.add_sequenced(msg.seq, msg.client_id, cs)
        apply_changeset(self.seq_forest, cs, msg.seq)
        self._invalidate()
        self.advance(msg.seq, msg.min_seq)
        if not local:
            self._emit("changed", {"changeset": cs}, local=False)

    # -- window / zamboni ------------------------------------------------------

    def advance(self, seq: int, min_seq: int) -> None:
        if min_seq <= self._min_seq:
            return
        self._min_seq = min_seq
        self.edit_manager.evict(min_seq)
        expired = [
            n.id for n in self.seq_forest.nodes.values()
            if n.removed_seq is not None and n.removed_seq <= min_seq
        ]
        if expired:
            for nid in expired:
                if self.seq_forest.contains(nid):
                    self.seq_forest.detach(nid)
                    self.seq_forest.purge_expired(nid, min_seq)
            self._invalidate()

    # -- summaries (normalized; SEMANTICS.md §canonical-summaries) -------------

    def summarize(self, min_seq: int = 0) -> SummaryTree:
        min_seq = max(min_seq, self._min_seq)
        tree = SummaryTree()
        root_obj = {
            "fields": self._summary_fields(ROOT_ID, min_seq),
            "minSeq": min_seq,
            "seq": self._last_seq,
        }
        # Detached (rescuable) subtrees survive summarize/reload — a later
        # sequenced move can still relocate them by id, so a freshly
        # loaded replica must know them or it would skip the rescue every
        # long-lived replica applies.  Limbo is derived from THIS summary's
        # window, not from past purges: with a caller min_seq beyond the
        # channel's advanced window (the container summarizes with its own
        # MSN), tombstones expire at serialization time and their kept
        # descendants must surface exactly as if the purge had run — the
        # same kept-under-unkept rule the device kernel extraction applies.
        limbo_ids = set(self.seq_forest.limbo_roots())
        for nid, n in self.seq_forest.nodes.items():
            if nid == ROOT_ID or n.parent is None:
                continue
            if not self._summary_keep(nid, min_seq):
                continue
            pid = n.parent[0]
            if pid != ROOT_ID and not self._summary_keep(pid, min_seq):
                limbo_ids.add(nid)
        limbo = [
            self._summary_node(nid, min_seq)
            for nid in sorted(limbo_ids)
            if self._summary_keep(nid, min_seq)
        ]
        if limbo:
            root_obj["limbo"] = limbo
        tree.add_blob("header", canonical_json(root_obj))
        if self._attributor is not None:
            # Attribution-enabled containers: pre-clamp (insert, value)
            # seqs per node in a SEPARATE blob — header bytes stay
            # kernel-identical; load() restores them so attribution_of
            # survives the window clamp (SURVEY §1 layer 8).  Keys cover
            # only nodes the summary actually EMITS (a kept node under an
            # expired-tombstone ancestor is dropped with its subtree and
            # must not leave an orphan key).
            emitted: set = set()

            def collect(node_obj: dict) -> None:
                emitted.add(node_obj["id"])
                for children in node_obj.get("fields", {}).values():
                    for child in children:
                        collect(child)

            for children in root_obj.get("fields", {}).values():
                for child in children:
                    collect(child)
            for spec in root_obj.get("limbo", []):
                collect(spec)
            keys = {
                nid: [n.insert_seq, n.value_seq]
                for nid, n in sorted(self.seq_forest.nodes.items())
                if nid in emitted
                and (0 < n.insert_seq <= min_seq
                     or 0 < n.value_seq <= min_seq)
            }
            if keys:
                tree.add_blob("attribution", canonical_json(keys))
        return tree

    def _summary_fields(self, node_id: str, min_seq: int) -> dict:
        n = self.seq_forest.node(node_id)
        return {
            f: [
                self._summary_node(cid, min_seq)
                for cid in sibs if self._summary_keep(cid, min_seq)
            ]
            for f, sibs in sorted(n.fields.items())
            if any(self._summary_keep(c, min_seq) for c in sibs)
        }

    def _summary_keep(self, node_id: str, min_seq: int) -> bool:
        n = self.seq_forest.nodes.get(node_id)
        if n is None:
            return False
        if n.removed_seq is not None and n.removed_seq <= min_seq:
            return False  # expired tombstone
        return True

    def _summary_node(self, node_id: str, min_seq: int) -> dict:
        n = self.seq_forest.node(node_id)
        obj: Dict[str, Any] = {
            "id": n.id,
            "type": n.type,
            "insertSeq": 0 if n.insert_seq <= min_seq else n.insert_seq,
        }
        if n.value is not None:
            obj["value"] = n.value
            obj["valueSeq"] = 0 if n.value_seq <= min_seq else n.value_seq
        if n.removed_seq is not None:
            obj["removedSeq"] = n.removed_seq
        fields = self._summary_fields(node_id, min_seq)
        if fields:
            obj["fields"] = fields
        return obj

    def load(self, summary: SummaryTree) -> None:
        obj = json.loads(summary.blob_bytes("header"))
        self.seq_forest = Forest()
        self.edit_manager = EditManager()
        self._min_seq = obj.get("minSeq", 0)
        self._last_seq = obj.get("seq", 0)
        root = self.seq_forest.node(ROOT_ID)
        for f, children in obj.get("fields", {}).items():
            for child in children:
                self._load_node(child, ROOT_ID, f)
                root.fields.setdefault(f, []).append(child["id"])
        for spec in obj.get("limbo", []):
            self._load_node(spec, ROOT_ID, "")
            self.seq_forest.node(spec["id"]).parent = None  # detached
        if "attribution" in summary.children:
            # Restore pre-clamp seqs via the ONE shared helper (the
            # catch-up service's warm-base pack uses it too).
            def get_seqs(nid):
                n = self.seq_forest.nodes.get(nid)
                return None if n is None else (n.insert_seq, n.value_seq)

            def put_seqs(nid, ins, val):
                n = self.seq_forest.nodes[nid]
                n.insert_seq, n.value_seq = ins, val

            restore_attribution_seqs(
                json.loads(summary.blob_bytes("attribution")),
                get_seqs, put_seqs,
            )
        self.discard_pending()
        self._invalidate()

    def _load_node(self, obj: dict, parent_id: str, field: str) -> None:
        n = TreeNode(
            id=obj["id"], type=obj["type"],
            value=obj.get("value"), value_seq=obj.get("valueSeq", 0),
            insert_seq=obj["insertSeq"],
            removed_seq=obj.get("removedSeq"),
            parent=(parent_id, field),
        )
        self.seq_forest.nodes[n.id] = n
        for f, children in obj.get("fields", {}).items():
            for child in children:
                self._load_node(child, n.id, f)
                n.fields.setdefault(f, []).append(child["id"])


class _Transaction:
    """Context manager: edits inside are squashed (composed) into a single
    changeset — one op, one ack, atomic for remote replicas.  On exception
    the collected edits are simply dropped (nothing was submitted; the
    predicted view rebuilds without them)."""

    def __init__(self, tree: SharedTree) -> None:
        self.tree = tree

    def __enter__(self) -> "_Transaction":
        if self.tree._txn_edits is not None:
            raise RuntimeError("nested transactions are not supported")
        self.tree._txn_edits = []
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        edits = self.tree._txn_edits
        self.tree._txn_edits = None
        self.tree._invalidate()
        if exc_type is None and edits:
            self.tree._submit_changeset(compose([{"edits": edits}]))
