"""The pinned SharedTree catch-up workload, with no JAX import.

A copy of the reference's tree bench corpus (``tools/bench_kernels.py``:
``tree_shape``, ``synth_tree_messages``, ``tree_doc``): the same RNG
draws give the same messages, message for message.  Shapes, by
``idx % 32`` then parity: revive, multi-id move and MAX_DEPTH overflow
(the three oracle-fallback shapes), then deep-move chains and
wide-container fan-out.  ``tree_windows`` cuts the base and grown windows
of the reference's ``run_tree_rebase``.

``random_tree_arrays`` makes packed forest and edit planes straight from
a seed, every index in its plane's domain (NIL included) but with no
structure, and ``wild_tree_arrays`` the same with values far outside it:
the kernel and the plain fold must agree on any such input, padding rows
too.  ``crafted_tree_cases`` are small hand-built planes for
the fold's NIL-index and aliasing rules.
"""

from __future__ import annotations

import random
from typing import List, Tuple

import numpy as np

from ..ops.tree_kernel import (
    K_INSERT,
    K_MOVE,
    K_REMOVE,
    K_SET,
    MAX_DEPTH,
    NIL,
    NOT_REMOVED,
    TreeDocInput,
    TreeEdits,
    TreeState,
    empty_tree_arrays,
)
from ..protocol.messages import MessageType, SequencedMessage

SHAPES = ("deep-move", "wide-container", "revive", "multi_id_move",
          "max_depth")


def tree_shape(idx: int) -> str:
    """Deterministic shape of document ``idx``: the three fallback shapes
    ride along at ~9%, the rest split between the two device-path
    shapes."""
    r = idx % 32
    if r == 0:
        return "revive"
    if r == 1:
        return "multi_id_move"
    if r == 2:
        return "max_depth"
    return "deep-move" if idx % 2 == 0 else "wide-container"


def _msg(seq: int, min_seq: int, edits: list) -> SequencedMessage:
    return SequencedMessage(
        seq=seq, client_id=f"c{seq % 3}", client_seq=seq, ref_seq=seq - 1,
        min_seq=min_seq, type=MessageType.OP, contents={"edits": edits},
    )


def synth_tree_messages(idx: int, n_edits: int) -> List[SequencedMessage]:
    """One document's deterministic SharedTree changeset stream.

    ``deep-move`` builds a nested chain and keeps moving leaves (and chain
    nodes, including dropped-cycle moves) through its containers, the
    ancestor-walk-heavy case; ``wide-container`` fans leaves out under two
    root fields with anchored inserts/removes/sets/moves; the fallback
    shapes inject one revive, one multi-id move, or a > MAX_DEPTH chain +
    move (device overflow) into otherwise normal traffic.  ``min_seq``
    advances periodically so purge windows and purge-gated edits
    execute."""
    rng = random.Random(idx * 48611 + 7)
    shape = tree_shape(idx)
    msgs, seq, min_seq = [], 0, 0
    counter = [0]

    def fresh() -> str:
        counter[0] += 1
        return f"t{idx}-n{counter[0]}"

    def emit(*edits):
        nonlocal seq, min_seq
        seq += 1
        if seq > 24 and seq % 10 == 0:
            min_seq = seq - 20
        msgs.append(_msg(seq, min_seq, list(edits)))

    def leaf(value: int) -> dict:
        return {"id": fresh(), "type": "n", "value": value}

    def ins(parent: str, field: str, spec: dict, anchor=None) -> dict:
        return {"kind": "insert", "parent": parent, "field": field,
                "anchor": anchor, "content": [spec]}

    live: list = []
    chain: list = []
    if shape in ("deep-move", "max_depth"):
        depth = (MAX_DEPTH + 6) if shape == "max_depth" \
            else rng.randint(8, 20)
        spec = leaf(0)
        chain.append(spec["id"])
        root_spec = spec
        for _ in range(depth - 1):
            child = leaf(0)
            spec["fields"] = {"k": [child]}
            spec = child
            chain.append(spec["id"])
        emit(ins("", "a", root_spec))
        if shape == "max_depth":
            # A move whose destination sits below MAX_DEPTH ancestors:
            # the fold's cycle walk overflows (the fallback reason).
            probe = leaf(1)
            live.append((probe["id"], probe["value"]))
            emit(ins("", "b", probe))
            emit({"kind": "move", "ids": [probe["id"]],
                  "parent": chain[-1], "field": "k", "anchor": None})
    removed: list = []
    for i in range(n_edits - len(msgs)):
        roll = rng.random()
        if shape == "revive" and i == n_edits // 2 and removed:
            nid, value = removed[-1]
            emit({"kind": "revive", "ids": [nid], "parent": "",
                  "field": "a", "anchor": None,
                  "content": [{"id": nid, "type": "n", "value": value}]})
            continue
        if shape == "multi_id_move" and i == n_edits // 2 \
                and len(live) >= 2:
            emit({"kind": "move", "ids": [live[0][0], live[1][0]],
                  "parent": "", "field": "b", "anchor": None})
            continue
        if shape in ("deep-move", "max_depth") and roll < 0.35 and chain:
            target_parent = rng.choice(chain)
            if roll < 0.12 and live:
                # a leaf deep into the chain (the ancestor-walk stab)
                emit({"kind": "move", "ids": [rng.choice(live)[0]],
                      "parent": target_parent, "field": "k",
                      "anchor": None})
            elif roll < 0.2 and len(chain) > 4:
                # a chain node into its own descendant: the cycle case
                hi = rng.randrange(2, len(chain) - 1)
                emit({"kind": "move", "ids": [chain[hi - 1]],
                      "parent": chain[hi], "field": "k", "anchor": None})
            else:
                spec = leaf(rng.randint(0, 99))
                live.append((spec["id"], spec["value"]))
                emit(ins(target_parent, "k", spec))
        elif roll < 0.45 or len(live) < 3:
            spec = leaf(rng.randint(0, 99))
            anchor = (rng.choice(live)[0]
                      if live and rng.random() < 0.5 else None)
            live.append((spec["id"], spec["value"]))
            emit(ins("", rng.choice(["a", "b"]), spec, anchor=anchor))
        elif roll < 0.65:
            nid, _v = rng.choice(live)
            emit({"kind": "set", "id": nid,
                  "value": rng.randint(0, 999)})
        elif roll < 0.8:
            k = rng.randrange(len(live))
            nid, value = live.pop(k)
            removed.append((nid, value))
            emit({"kind": "remove", "ids": [nid]})
        else:
            nid, _v = rng.choice(live)
            anchor = (rng.choice(live)[0]
                      if rng.random() < 0.5 else None)
            if anchor == nid:
                anchor = None
            emit({"kind": "move", "ids": [nid], "parent": "",
                  "field": rng.choice(["a", "b"]), "anchor": anchor})
    return msgs


def tree_doc(idx: int, msgs, n_msgs: int) -> TreeDocInput:
    """The catch-up work item over the stream's first ``n_msgs`` messages,
    under a fixed cache token, so grown windows extend under the tiers'
    identity contract."""
    window = msgs[:n_msgs]
    return TreeDocInput(
        doc_id=f"tdoc{idx}", ops=window, final_seq=window[-1].seq,
        final_msn=window[-1].min_seq,
        cache_token=("bench-epoch", f"tdoc{idx}", 0, ""),
    )


def tree_windows(n_docs: int, n_edits: int, grow_every: int = 8
                 ) -> Tuple[List[TreeDocInput], List[TreeDocInput]]:
    """``(base, grown)`` as the reference's ``run_tree_rebase`` cuts them:
    every stream less its last ``max(2, n_edits // 8)`` messages, then
    every ``grow_every``-th document at its full stream."""
    grow = max(2, n_edits // 8)
    streams = [synth_tree_messages(i, n_edits) for i in range(n_docs)]
    base = [tree_doc(i, s, len(s) - grow) for i, s in enumerate(streams)]
    grown = [tree_doc(i, s, len(s) if i % grow_every == 0 else len(s) - grow)
             for i, s in enumerate(streams)]
    return base, grown


def random_tree_arrays(seed: int, D: int, N: int, C: int, T: int
                       ) -> Tuple[TreeState, TreeEdits]:
    """Packed planes with every index drawn from its plane's domain (node
    indices in ``[-1, N)``, containers in ``[-1, C)``, edit containers in
    ``[0, C)``, targets in ``[0, N)``), a quarter of the edit rows no-ops
    and some tombstones below the purge bounds: no forest structure, so
    the NIL reads and writes, aliasing indices and cyclic ancestor chains
    of the fold all occur."""
    rng = np.random.RandomState(seed)

    def ints(lo, hi, shape):
        return rng.randint(lo, hi, size=shape).astype(np.int32)

    removed = np.where(rng.rand(D, N) < 0.6, int(NOT_REMOVED),
                       rng.randint(0, 60, size=(D, N))).astype(np.int32)
    state = TreeState(
        head=ints(-1, N, (D, C)), next=ints(-1, N, (D, N)),
        prev=ints(-1, N, (D, N)), node_container=ints(-1, C, (D, N)),
        container_parent=ints(-1, N, (D, C)), value=ints(-1, 40, (D, N)),
        value_seq=ints(0, 80, (D, N)), insert_seq=ints(0, 80, (D, N)),
        removed_seq=removed, overflow=rng.rand(D) < 0.1)
    kind = ints(1, 5, (D, T))
    kind[rng.rand(D, T) < 0.25] = 0
    edits = TreeEdits(
        kind=kind, seq=np.cumsum(ints(1, 3, (D, T)), axis=1,
                                 dtype=np.int32),
        container=ints(0, C, (D, T)), anchor=ints(-1, N, (D, T)),
        first=ints(0, N, (D, T)), tail=ints(0, N, (D, T)),
        value=ints(-1, 40, (D, T)), purge_msn=ints(-1, 60, (D, T)))
    return state, edits


def wild_tree_arrays(seed: int, D: int, N: int, C: int, T: int
                     ) -> Tuple[TreeState, TreeEdits]:
    """``random_tree_arrays`` with about 15% of every int32 entry but the
    edit kinds replaced by a value far outside its plane: the int32
    extremes, -2, counts from the end past the plane (-N - 3, -3N, -C)
    and indices past it (N, N + 1, 3N, C + 2).  The index rules at both
    ends of the int32 range then decide every read and write."""
    state, edits = random_tree_arrays(seed, D, N, C, T)
    rng = np.random.RandomState(seed + 7919)
    odd = np.array([-2 ** 31, 2 ** 31 - 1, -1, -2, -N - 3, -3 * N, N, N + 1,
                    3 * N, -C, C + 2], dtype=np.int64)

    def spoil(a):
        a = a.astype(np.int64)
        pick = rng.rand(*a.shape) < 0.15
        a[pick] = rng.choice(odd, size=int(pick.sum()))
        return a.astype(np.int32)

    state = TreeState(**{f: x if f == "overflow" else spoil(x)
                         for f, x in state._asdict().items()})
    edits = TreeEdits(**{f: x if f == "kind" else spoil(x)
                         for f, x in edits._asdict().items()})
    return state, edits


def _edit_rows(ed: dict, d: int, rows) -> None:
    for t, row in enumerate(rows):
        for f, v in dict(dict(seq=t + 1), **row).items():
            ed[f][d, t] = v


def crafted_tree_cases():
    """``{name: (TreeState, TreeEdits)}`` of numpy planes, each a few
    documents built to hit one of the fold's index rules:

    - ``unlinked_move_target``: a move of a node in no container, whose
      detach writes the head slot of container NIL, i.e. the last one;
    - ``nil_dest_owner``: a move into a container owned by NIL, gated by
      the expiry read at NIL (the last node row): expired in document 0,
      alive in document 1;
    - ``anchor_is_target``: a move anchored at its own target (falls back
      to the field start), and an insert whose anchor, chain head and
      tail are one node (the aliasing writes, last one wins);
    - ``deep_chain``: containers nested 75 deep; a move whose target the
      walk meets within MAX_DEPTH steps while the walk is still going
      after them (overflow, no move), and one whose target lies deeper
      than the walk reaches (overflow, and the move happens);
    - ``purge_gates``: inserts and moves at expired anchors, a remove of
      a tombstone and a set, at purge bounds either side of the
      tombstones' seqs."""
    cases = {}

    # unlinked move target
    st, ed = empty_tree_arrays(1, 8, 4, 4)
    st["container_parent"][0, :3] = [0, 0, 1]
    st["node_container"][0, 1:4] = [0, 0, 2]
    st["head"][0, :] = [1, NIL, 3, 5]   # head[C-1] set, to see the write
    st["next"][0, 1] = 2
    st["prev"][0, 2] = 1
    _edit_rows(ed, 0, [dict(kind=K_MOVE, container=1, anchor=NIL, first=6,
                            tail=6),
                       dict(kind=K_MOVE, container=0, anchor=2, first=7,
                            tail=7)])
    cases["unlinked_move_target"] = (st, ed)

    # NIL destination owner; the expiry read at NIL is the last row
    st, ed = empty_tree_arrays(2, 8, 4, 4)
    for d in range(2):
        st["container_parent"][d, :2] = [0, 0]       # containers 2, 3: NIL
        st["node_container"][d, 1:4] = [0, 0, 1]
        st["head"][d, :2] = [1, 3]
        st["next"][d, 1] = 2
        st["prev"][d, 2] = 1
        _edit_rows(ed, d, [dict(kind=K_MOVE, container=2, anchor=NIL,
                                first=2, tail=2, purge_msn=5),
                           dict(kind=K_MOVE, container=3, anchor=1, first=3,
                                tail=3, purge_msn=5)])
    st["removed_seq"][0, 7] = 4                      # expired at purge 5
    cases["nil_dest_owner"] = (st, ed)

    # a move anchored at its own target; an insert aliasing one node
    st, ed = empty_tree_arrays(1, 8, 4, 4)
    st["container_parent"][0, :2] = [0, 0]
    st["node_container"][0, 1:6] = [0, 0, 1, 1, 0]
    st["head"][0, :2] = [1, 3]
    st["next"][0, [1, 3]] = [2, 4]
    st["prev"][0, [2, 4]] = [1, 3]
    _edit_rows(ed, 0, [dict(kind=K_MOVE, container=0, anchor=4, first=4,
                            tail=4),
                       dict(kind=K_INSERT, container=0, anchor=5, first=5,
                            tail=5),
                       dict(kind=K_INSERT, container=1, anchor=3, first=3,
                            tail=2)])
    cases["anchor_is_target"] = (st, ed)

    # nested 75 deep: node i owns container i, node i + 1 lives in it
    depth, N, C = 75, 96, 80
    st, ed = empty_tree_arrays(2, N, C, 2)
    for d in range(2):
        st["container_parent"][d, :depth + 1] = np.arange(depth + 1)
        st["node_container"][d, 1:depth + 2] = np.arange(depth + 1)
        st["head"][d, :depth + 1] = np.arange(1, depth + 2)
    _edit_rows(ed, 0, [dict(kind=K_MOVE, container=depth, anchor=NIL,
                            first=depth - 5, tail=depth - 5)])
    _edit_rows(ed, 1, [dict(kind=K_MOVE, container=depth, anchor=NIL,
                            first=3, tail=3)])
    cases["deep_chain"] = (st, ed)

    # purge gates either side of the tombstones
    st, ed = empty_tree_arrays(2, 8, 4, 6)
    for d in range(2):
        st["container_parent"][d, :2] = [0, 0]
        st["node_container"][d, 1:5] = [0, 0, 0, 1]
        st["head"][d, :2] = [1, 4]
        st["next"][d, 1:3] = [2, 3]
        st["prev"][d, 2:4] = [1, 2]
        st["removed_seq"][d, [2, 4]] = [3, 6]
        purge = 5 if d == 0 else 2
        _edit_rows(ed, d, [
            dict(kind=K_INSERT, container=0, anchor=2, first=5, tail=5,
                 purge_msn=purge),
            dict(kind=K_MOVE, container=1, anchor=2, first=1, tail=1,
                 purge_msn=purge),
            dict(kind=K_MOVE, container=0, anchor=NIL, first=4, tail=4,
                 purge_msn=purge),
            dict(kind=K_REMOVE, first=2, purge_msn=purge),
            dict(kind=K_REMOVE, first=3, purge_msn=purge),
            dict(kind=K_SET, first=3, value=7, purge_msn=purge)])
    st["node_container"][:, 5] = 0
    cases["purge_gates"] = (st, ed)
    return {name: (TreeState(**st), TreeEdits(**ed))
            for name, (st, ed) in cases.items()}
