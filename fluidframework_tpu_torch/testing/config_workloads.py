"""The SharedMap, interval and SharedMatrix workloads of BASELINE.json
(configs #2, #3 and #4), with no JAX import.

``gen_map_doc``, ``gen_interval_doc`` and ``gen_matrix_doc`` are copies
of the reference harness's generators (``tools/bench_configs.py``), and
``synth_interval_doc`` of its interval stabbing workload
(``tools/bench_kernels.py``): the same RNG draws and the same messages,
as the port's ``MapDocInput`` / ``MergeTreeDocInput`` /
``MatrixDocInput``.  Every message rides a fully sequential view
(``ref_seq = seq - 1``), so these workloads never resolve in a lagging
view; the committed fixtures
(``hard_map_docs.json``, ``hard_matrix_docs.json``, read by ``hard_*``
below) carry the concurrent cases, and ``crafted_map_docs`` /
``crafted_matrix_doc`` the edge cases the kernels must get right;
``adversarial_lww_inputs`` makes the map reduction's packed inputs
straight from a seed, off the packer's layout and values.
"""

from __future__ import annotations

import json
import os
import random
from typing import List

from ..ops.map_kernel import MapDocInput
from ..ops.matrix_kernel import MatrixDocInput
from ..ops.mergetree_kernel import MergeTreeDocInput
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


ALPHABET = "abcdefghijklmnopqrstuvwxyz "


def gen_interval_doc(idx: int, n_ops: int) -> MergeTreeDocInput:
    """Config #3: text traffic carrying a live interval population —
    adds/changes/deletes against sliding local references (message-list
    ingestion; interval ops never ride the binary stream)."""
    rng = random.Random(idx * 9973 + 29)
    ops, length = [], 0
    live: list = []
    for i in range(n_ops):
        seq = i + 1
        client = f"client{i % 3}"
        r = rng.random()
        if r < 0.5 or length < 8:
            pos = rng.randint(0, length)
            text = "".join(
                rng.choice(ALPHABET) for _ in range(rng.randint(1, 8))
            )
            contents = {"kind": "insert", "pos": pos, "text": text}
            length += len(text)
        elif r < 0.7:
            start = rng.randint(0, length - 2)
            end = min(length, start + rng.randint(1, 8))
            contents = {"kind": "remove", "start": start, "end": end}
            length -= end - start
        elif r < 0.85 or not live:
            iid = f"iv{idx}-{seq}"
            start = rng.randint(0, length - 2)
            end = min(length - 1, start + rng.randint(1, 12))
            contents = {"kind": "intervalAdd", "label": "default",
                        "id": iid, "start": start, "end": end,
                        "props": {"c": rng.randint(0, 5)}}
            live.append(iid)
        elif r < 0.95:
            iid = rng.choice(live)
            start = rng.randint(0, length - 2)
            contents = {"kind": "intervalChange", "label": "default",
                        "id": iid, "start": start,
                        "end": min(length - 1, start + rng.randint(1, 12))}
        else:
            iid = live.pop(rng.randrange(len(live)))
            contents = {"kind": "intervalDelete", "label": "default",
                        "id": iid}
        ops.append(_msg(seq, client, contents))
    return MergeTreeDocInput(doc_id=f"iv{idx}", ops=ops,
                             final_seq=n_ops, final_msn=0)


def synth_interval_doc(idx: int, n_ops: int,
                       n_msgs=None) -> MergeTreeDocInput:
    """A string document with a DENSE interval population over segments
    that later removes force through the slide cascade: phase 1 builds
    text, phase 2 attaches ~n/4 intervals across it, phase 3 removes
    spans (every ref on a removed segment must slide — repeatedly, when
    the landing segment is itself removed later), phase 4 keeps
    churning adds/changes/deletes.  The stabbing workload for
    ``ops/interval_replay.py``.  ``n_msgs`` cuts the stream to its first
    messages under one cache token, so a longer window extends a shorter
    one under the cache tiers' identity contract."""
    rng = random.Random(idx * 7103 + 3)
    ops, length = [], 0
    live: list = []
    for i in range(n_ops):
        seq = i + 1
        client = f"client{i % 3}"
        phase = i * 4 // n_ops
        r = rng.random()
        if phase == 0 or length < 16:
            pos = rng.randint(0, length)
            text = "".join(
                rng.choice(ALPHABET) for _ in range(rng.randint(2, 8)))
            contents = {"kind": "insert", "pos": pos, "text": text}
            length += len(text)
        elif phase == 1 or (phase == 3 and (r < 0.4 or not live)):
            iid = f"iv{idx}-{seq}"
            start = rng.randint(0, length - 2)
            contents = {"kind": "intervalAdd", "label": "default",
                        "id": iid, "start": start,
                        "end": min(length - 1, start + rng.randint(1, 12)),
                        "props": {"c": rng.randint(0, 5)}}
            live.append(iid)
        elif phase == 2 and r < 0.7:
            start = rng.randint(0, length - 2)
            end = min(length, start + rng.randint(2, 10))
            contents = {"kind": "remove", "start": start, "end": end}
            length -= end - start
        elif r < 0.7:
            iid = rng.choice(live)
            start = rng.randint(0, max(0, length - 2))
            contents = {"kind": "intervalChange", "label": "default",
                        "id": iid, "start": start,
                        "end": min(length - 1,
                                   start + rng.randint(1, 12))}
        else:
            iid = live.pop(rng.randrange(len(live)))
            contents = {"kind": "intervalDelete", "label": "default",
                        "id": iid}
        ops.append(_msg(seq, client, contents))
    window = ops[:n_msgs] if n_msgs is not None else ops
    return MergeTreeDocInput(
        doc_id=f"ivdoc{idx}", ops=window, final_seq=window[-1].seq,
        final_msn=0,
        cache_token=("bench-epoch", f"ivdoc{idx}", 0, ""),
    )


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


#: the shape of ``adversarial_lww_inputs``: op rows, key buckets, clear
#: rows, documents
ADVERSARIAL_LWW_SHAPE = (4096, 96, 64, 11)


def adversarial_lww_inputs(seed: int):
    """``(LWWInputs of int32 numpy arrays, num_docs)``: the map reduction's
    seven inputs made from ``seed``, off the packer's layout and values,
    for holding the plain reduction to the JAX package's and the kernel
    to the plain one on every int32 input.  The rows are shuffled out of
    document order; one key holds 3,000 of the 4,096 rows;
    ``is_set`` / ``val_idx`` take values far below -1 and above 1, the
    int32 extremes included; ``key_gid`` and ``clear_doc`` run out of
    range on both sides; ``key_doc`` counts from the end or past it;
    seqs tie, at ``INT32_MIN`` too.  Three keys are fixed: a winner whose
    payloads are below -1 beside a loser (both outputs read -1), tied
    winners below -1 with no loser, and a key whose rows all sit at
    ``INT32_MIN``."""
    import numpy as np

    from ..ops.map_kernel import LWWInputs

    N, G, M, docs = ADVERSARIAL_LWW_SHAPE
    lo, hi = -2 ** 31, 2 ** 31 - 1
    rng = np.random.RandomState(seed)

    def draw(n, low, high, odd):
        """Small ints, with ~30% of the entries drawn from ``odd``."""
        a = rng.randint(low, high, size=n).astype(np.int64)
        pick = rng.rand(n) < 0.3
        a[pick] = rng.choice(odd, size=int(pick.sum()))
        return a

    extremes = [lo, lo + 1, -1000, -2, -1, 0, 1, 2, 1000, hi]
    key_gid = draw(N, 0, G, [-1, -7, G, G + 5, lo, hi])
    key_gid[rng.rand(N) < 3000 / N] = 5
    op_seq = draw(N, -3, 5, [lo, lo + 1, hi, -1])
    is_set = draw(N, -5, 5, extremes)
    val_idx = draw(N, -5, 12, extremes)
    # key 7: a winner (seq 9) with payloads below -1 and a loser (seq 3);
    # key 8: tied winners below -1, no loser; key 9: every row at INT32_MIN
    fixed = [(7, 9, -7, -9), (7, 3, 1, 4), (8, 6, -7, -3), (8, 6, -5, -8),
             (9, lo, lo, lo), (9, lo, -5, lo)]
    key_gid[np.isin(key_gid, (7, 8, 9))] = 5
    for i, row in enumerate(fixed):
        key_gid[i], op_seq[i], is_set[i], val_idx[i] = row
    order = rng.permutation(N)
    key_doc = draw(G, 0, docs, [-1, -docs, -docs - 4, docs, docs + 3, lo, hi])
    clear_doc = draw(M, 0, docs, [-1, -3, docs, docs + 2, lo, hi])
    clear_seq = draw(M, -3, 5, [lo, lo + 1, hi])
    arrays = [key_gid[order], op_seq[order], is_set[order], val_idx[order],
              key_doc, clear_doc, clear_seq]
    return LWWInputs(*(np.ascontiguousarray(a, dtype=np.int32)
                       for a in arrays)), docs


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
