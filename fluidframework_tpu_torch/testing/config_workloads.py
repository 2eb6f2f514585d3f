"""The SharedMap and SharedMatrix workloads of BASELINE.json (configs #2
and #4), with no JAX import.

``gen_map_doc`` and ``gen_matrix_doc`` are copies of the reference
harness's generators (``tools/bench_configs.py``): the same RNG draws and
the same messages, as the port's ``MapDocInput`` / ``MatrixDocInput``.
Every message rides a fully sequential view (``ref_seq = seq - 1``), so
these workloads never resolve in a lagging view; the committed fixtures
(``hard_map_docs.json``, ``hard_matrix_docs.json``, read by ``hard_*``
below) carry the concurrent cases, and ``crafted_map_docs`` /
``crafted_matrix_doc`` the edge cases the kernels must get right.
"""

from __future__ import annotations

import json
import os
import random
from typing import List

from ..ops.map_kernel import MapDocInput
from ..ops.matrix_kernel import MatrixDocInput
from ..protocol.messages import MessageType, SequencedMessage
from ..protocol.summary import SummaryTree

_HERE = os.path.dirname(os.path.abspath(__file__))
MAP_FIXTURE = os.path.join(_HERE, "hard_map_docs.json")
MATRIX_FIXTURE = os.path.join(_HERE, "hard_matrix_docs.json")


def _msg(seq: int, client: str, contents: dict) -> SequencedMessage:
    return SequencedMessage(
        seq=seq, client_id=client, client_seq=seq, ref_seq=seq - 1,
        min_seq=0, type=MessageType.OP, contents=contents,
    )


def gen_map_doc(idx: int, n_ops: int) -> MapDocInput:
    """Config #2: LWW key traffic over a zipf-ish key population, 3 clients,
    92% set / 6% delete / 2% clear."""
    rng = random.Random(idx * 6271 + 5)
    n_keys = 24
    ops = []
    for i in range(n_ops):
        seq = i + 1
        client = f"client{i % 3}"
        r = rng.random()
        key = f"k{int(rng.random() ** 2 * n_keys)}"
        if r < 0.92:
            contents = {"kind": "set", "key": key,
                        "value": rng.randint(0, 999)}
        elif r < 0.98:
            contents = {"kind": "delete", "key": key}
        else:
            contents = {"kind": "clear"}
        ops.append(_msg(seq, client, contents))
    return MapDocInput(doc_id=f"map{idx}", ops=ops)


def gen_matrix_doc(idx: int, n_ops: int) -> MatrixDocInput:
    """Config #4: row/col growth + removals + cell sets on the live grid."""
    rng = random.Random(idx * 3557 + 11)
    ops, rows, cols = [], 0, 0
    for i in range(n_ops):
        seq = i + 1
        client = f"client{i % 3}"
        r = rng.random()
        if r < 0.18 or rows == 0:
            count = rng.randint(1, 3)
            contents = {"kind": "insertRows",
                        "pos": rng.randint(0, rows), "count": count}
            rows += count
        elif r < 0.36 or cols == 0:
            count = rng.randint(1, 3)
            contents = {"kind": "insertCols",
                        "pos": rng.randint(0, cols), "count": count}
            cols += count
        elif r < 0.42 and rows > 2:
            start = rng.randint(0, rows - 2)
            end = min(rows, start + rng.randint(1, 2))
            contents = {"kind": "removeRows", "start": start, "end": end}
            rows -= end - start
        elif r < 0.48 and cols > 2:
            start = rng.randint(0, cols - 2)
            end = min(cols, start + rng.randint(1, 2))
            contents = {"kind": "removeCols", "start": start, "end": end}
            cols -= end - start
        else:
            contents = {"kind": "setCell", "row": rng.randint(0, rows - 1),
                        "col": rng.randint(0, cols - 1),
                        "value": rng.randint(0, 999)}
        ops.append(_msg(seq, client, contents))
    return MatrixDocInput(doc_id=f"mx{idx}", ops=ops,
                          final_seq=n_ops, final_msn=0)


# -- the committed fixtures --------------------------------------------------


def map_doc_to_json(doc) -> dict:
    """The map fixture's form of a document (read by attribute name, so
    the JAX package's ``MapDocInput`` dumps the same way)."""
    return {"doc_id": doc.doc_id, "ops": [m.to_dict() for m in doc.ops],
            "base": doc.base}


def map_doc_from_json(obj: dict) -> MapDocInput:
    return MapDocInput(
        doc_id=obj["doc_id"],
        ops=[SequencedMessage.from_dict(m) for m in obj["ops"]],
        base=obj["base"])


def matrix_doc_to_json(doc) -> dict:
    """The matrix fixture's form of a document: its messages, and its base
    summary's two blobs as text (read by attribute name, as above)."""
    base = doc.base_summary
    return {"doc_id": doc.doc_id, "ops": [m.to_dict() for m in doc.ops],
            "base_summary": None if base is None else {
                name: base.blob_bytes(name).decode()
                for name in ("header", "body")},
            "final_seq": doc.final_seq, "final_msn": doc.final_msn}


def matrix_doc_from_json(obj: dict) -> MatrixDocInput:
    base = None
    if obj["base_summary"] is not None:
        base = SummaryTree()
        for name in ("header", "body"):
            base.add_blob(name, obj["base_summary"][name].encode())
    return MatrixDocInput(
        doc_id=obj["doc_id"],
        ops=[SequencedMessage.from_dict(m) for m in obj["ops"]],
        base_summary=base, final_seq=obj["final_seq"],
        final_msn=obj["final_msn"])


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def hard_map_docs() -> List[MapDocInput]:
    """The map fixture: fuzz logs, a base-summary tail, an empty and a
    clear-only document."""
    return [map_doc_from_json(d) for d in load_json(MAP_FIXTURE)["docs"]]


def hard_matrix_docs() -> List[MatrixDocInput]:
    """The matrix fixture: LWW and FWW fuzz logs, a base-summary tail, the
    directed concurrent document, a base with two overlap removers (routed
    to the oracle before packing) and a third remover (an axis overflow,
    routed to the oracle after the fold)."""
    return [matrix_doc_from_json(d)
            for d in load_json(MATRIX_FIXTURE)["docs"]]


# -- crafted edge cases --------------------------------------------------------


def _op(seq: int, client: str, contents: dict, ref_seq=None):
    return SequencedMessage(
        seq=seq, client_id=client, client_seq=seq,
        ref_seq=seq - 1 if ref_seq is None else ref_seq, min_seq=0,
        type=MessageType.OP, contents=contents)


#: the map cases (``crafted_map_docs``)
CRAFTED_MAP = ("base-no-clear", "exact-bucket", "delete-only", "mixed")


def crafted_map_docs(case: str) -> List[MapDocInput]:
    """The LWW reduction's empty-segment cases:

    - ``base-no-clear``: base keys and no clear op (``last_clear`` stays
      at INT32_MIN, so base keys at seq 0 survive);
    - ``exact-bucket``: exactly 64 keys, so the key axis has no padding
      entry and the padding op rows land on key 0;
    - ``delete-only``: a key only ever deleted, and a set key whose later
      delete wins;
    - ``mixed``: the three above beside an empty document, in one batch.
    """
    if case == "base-no-clear":
        return [MapDocInput("base-no-clear", [
            _op(1, "A", {"kind": "set", "key": "z", "value": 3}),
            _op(2, "B", {"kind": "delete", "key": "y"}),
        ], base={"x": 1, "y": 2, "w": {"nested": [1, 2]}})]
    if case == "exact-bucket":
        ops = [_op(i + 1, f"c{i % 3}",
                   {"kind": "set", "key": f"k{i}", "value": i % 7})
               for i in range(64)]
        ops += [_op(65 + i, "c0", {"kind": "delete", "key": f"k{2 * i}"})
                for i in range(6)]
        return [MapDocInput("exact-bucket", ops)]
    if case == "delete-only":
        return [MapDocInput("delete-only", [
            _op(1, "A", {"kind": "delete", "key": "gone"}),
            _op(2, "A", {"kind": "set", "key": "k", "value": 1}),
            _op(3, "B", {"kind": "delete", "key": "k"}),
            _op(4, "B", {"kind": "set", "key": "j", "value": None}),
        ])]
    if case == "mixed":
        return (crafted_map_docs("base-no-clear") + [MapDocInput("e", [])]
                + crafted_map_docs("exact-bucket")
                + crafted_map_docs("delete-only"))
    raise ValueError(case)


#: the matrix cases (``crafted_matrix_doc``)
CRAFTED_MATRIX = ("zero-width-chunk-end", "past-the-view", "resolve-order")


def crafted_matrix_doc(case: str) -> MatrixDocInput:
    """The resolving fold's edge cases:

    - ``zero-width-chunk-end``: 33 single-row slots, row 31 removed; a
      setCell at row 31 lands in slot 32, after the zero-width slot 31 at
      ``cum == 31`` that ends the first 32-slot chunk; a lagged setCell
      (its view before the remove) resolves into slot 31 itself; row 32
      then lies past the view;
    - ``past-the-view``: setCells past the rows and the columns of their
      view, and on an axis that is still empty;
    - ``resolve-order``: each setCell reads the state its earlier rows
      built (an insert before it shifts its handle), in its own view (a
      lagged writer does not see that insert).
    """
    ops: List[SequencedMessage] = []

    def add(client, contents, ref_seq=None):
        ops.append(_op(len(ops) + 1, client, contents, ref_seq))

    if case == "zero-width-chunk-end":
        add("c0", {"kind": "insertCols", "pos": 0, "count": 1})
        for i in range(33):
            add(f"c{i % 2}", {"kind": "insertRows", "pos": i, "count": 1})
        add("c0", {"kind": "removeRows", "start": 31, "end": 32})
        add("c1", {"kind": "setCell", "row": 31, "col": 0, "value": "after"})
        add("c2", {"kind": "setCell", "row": 31, "col": 0, "value": "lag"},
            ref_seq=len(ops) - 2)
        add("c0", {"kind": "setCell", "row": 32, "col": 0, "value": "x"})
    elif case == "past-the-view":
        add("c0", {"kind": "insertRows", "pos": 0, "count": 2})
        add("c1", {"kind": "setCell", "row": 0, "col": 0, "value": "no-col"})
        add("c0", {"kind": "insertCols", "pos": 0, "count": 1})
        add("c1", {"kind": "setCell", "row": 2, "col": 0, "value": "row"})
        add("c2", {"kind": "setCell", "row": 0, "col": 1, "value": "col"})
        add("c0", {"kind": "setCell", "row": 1, "col": 0, "value": "ok"})
    elif case == "resolve-order":
        add("c0", {"kind": "insertRows", "pos": 0, "count": 1})
        add("c0", {"kind": "insertCols", "pos": 0, "count": 1})
        add("c1", {"kind": "setCell", "row": 0, "col": 0, "value": "h0"})
        add("c0", {"kind": "insertRows", "pos": 0, "count": 1})
        add("c1", {"kind": "setCell", "row": 0, "col": 0, "value": "h1"})
        add("c2", {"kind": "setCell", "row": 0, "col": 0, "value": "lag"},
            ref_seq=3)
    else:
        raise ValueError(case)
    return MatrixDocInput(doc_id=case, ops=ops, final_seq=len(ops),
                          final_msn=0)
