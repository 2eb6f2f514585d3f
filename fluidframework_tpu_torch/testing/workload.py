"""The port's workloads, with no JAX import.

- ``synth_doc`` — the pinned catch-up workload of BASELINE.md config #1:
  a copy of ``bench.synth_doc`` (same RNG draws, same binary blobs);
- ``hard_docs`` — the hard-semantics fixture ``hard_mergetree_docs.json``:
  a JSON dump of the JAX package's ``__graft_entry__._hard_mergetree_docs``
  (deep-lag obliterate arrival kill, overlap removers, annotate race,
  lagged fuzz logs, a warm base with obliterate stamps) plus a directed
  overflow document (three removers of one range);
- ``cold_fixture_docs`` — the fixture's documents without a base summary,
  copied under new ids: a cold corpus with obliterates and lagging views
  (its chunk keeps the obliterate and overlap-remover rows);
- ``layout_metas`` — copies of a chunk's meta for every transfer layout
  its facts allow (turning a narrowing fact off, or a row elision off,
  is always legal; the reverse is not);
- ``doc_to_json`` / ``doc_from_json`` — the fixture's document format.

Long documents for the device-memory placement are ``synth_doc`` with
more ops: 2,000 ops pack to S = 4,096 slots.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import random
from typing import Iterator, List, Tuple

from ..dds.sequence import SharedString
from ..ops.interning import Interner
from ..ops.mergetree_kernel import MergeTreeDocInput
from ..ops.native_pack import decode_string_ops, encode_string_ops
from ..protocol.messages import MessageType, SequencedMessage

ALPHABET = "abcdefghijklmnopqrstuvwxyz "
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "hard_mergetree_docs.json")


def synth_doc(doc_idx: int, n_ops: int) -> MergeTreeDocInput:
    """A valid sequenced op stream: 3 clients round-robin, mixed edits.
    70% of documents are pure insert/remove text traffic; 30% carry
    annotate ops with props.  Every stream rides the native binary record
    format.  Draw for draw the generator of ``bench.synth_doc`` — do not
    change it without re-measuring the pinned workload."""
    rng = random.Random(doc_idx * 7919 + 13)
    annotating_doc = doc_idx % 10 >= 7
    ops, length = [], 0
    for i in range(n_ops):
        seq = i + 1
        client = f"client{i % 3}"
        r = rng.random()
        if not annotating_doc:
            r = min(r, 0.89)  # no annotates in pure-text docs
        if r < 0.62 or length < 4:
            pos = rng.randint(0, length)
            text = "".join(
                rng.choice(ALPHABET) for _ in range(rng.randint(1, 8))
            )
            contents = {"kind": "insert", "pos": pos, "text": text}
            length += len(text)
        elif r < 0.9:
            start = rng.randint(0, length - 2)
            end = min(length, start + rng.randint(1, 8))
            contents = {"kind": "remove", "start": start, "end": end}
            length -= end - start
        else:
            start = rng.randint(0, length - 2)
            end = min(length, start + rng.randint(1, 8))
            contents = {
                "kind": "annotate", "start": start, "end": end,
                "props": {"f": rng.randint(0, 3)},
            }
        ops.append(
            SequencedMessage(
                seq=seq, client_id=client, client_seq=seq, ref_seq=seq - 1,
                min_seq=0, type=MessageType.OP, contents=contents,
            )
        )
    clients, keys, vals = Interner(), Interner(), Interner()
    blob = encode_string_ops(ops, clients, keys, vals)
    return MergeTreeDocInput(
        doc_id=f"doc{doc_idx}", ops=[], binary_ops=blob,
        binary_clients=list(clients.values),
        binary_prop_keys=list(keys.values) or None,
        binary_values=list(vals.values) or None,
        final_seq=n_ops, final_msn=0,
    )


def doc_ops(doc: MergeTreeDocInput) -> List[SequencedMessage]:
    """A document's op tail as messages (decoding a binary stream)."""
    if doc.binary_ops is None:
        return list(doc.ops)
    return decode_string_ops(
        doc.binary_ops, list(doc.binary_clients or []),
        prop_keys=doc.binary_prop_keys, values=doc.binary_values,
    )


def oracle_replay(doc: MergeTreeDocInput) -> SharedString:
    """The CPU oracle's replica after the document's base and tail."""
    replica = SharedString(doc.doc_id)
    if doc.base_records is not None:
        replica.tree.load_records(doc.base_records, doc.base_seq,
                                  doc.base_msn)
        for label, obj in (doc.base_intervals or {}).items():
            replica.get_interval_collection(label).load_obj(obj)
    for msg in doc_ops(doc):
        replica.process(msg, local=False)
    replica.advance(doc.final_seq, doc.final_msn)
    return replica


def doc_to_json(doc) -> dict:
    """The fixture's form of a message-list document (read by attribute
    name, so the JAX package's doc inputs dump the same way)."""
    return {
        "doc_id": doc.doc_id,
        "ops": [m.to_dict() for m in doc.ops],
        "base_records": doc.base_records,
        "base_seq": doc.base_seq,
        "base_msn": doc.base_msn,
        "base_intervals": doc.base_intervals,
        "final_seq": doc.final_seq,
        "final_msn": doc.final_msn,
    }


def doc_from_json(obj: dict) -> MergeTreeDocInput:
    return MergeTreeDocInput(
        doc_id=obj["doc_id"],
        ops=[SequencedMessage.from_dict(m) for m in obj["ops"]],
        base_records=obj["base_records"],
        base_seq=obj["base_seq"],
        base_msn=obj["base_msn"],
        base_intervals=obj["base_intervals"],
        final_seq=obj["final_seq"],
        final_msn=obj["final_msn"],
    )


def overflow_doc() -> MergeTreeDocInput:
    """Three clients at ref 1 remove the same range: a third remover of
    one segment, which the device state cannot hold — the fold raises
    ``overflow`` and the document falls back to the oracle."""
    def msg(seq, client, ref_seq, contents):
        return SequencedMessage(
            seq=seq, client_id=client, client_seq=1, ref_seq=ref_seq,
            min_seq=0, type=MessageType.OP, contents=contents)

    return MergeTreeDocInput(doc_id="overflow", ops=[
        msg(1, "c0", 0, {"kind": "insert", "pos": 0, "text": "abcdef"}),
        msg(2, "c1", 1, {"kind": "remove", "start": 1, "end": 4}),
        msg(3, "c2", 1, {"kind": "remove", "start": 1, "end": 4}),
        msg(4, "c3", 1, {"kind": "remove", "start": 1, "end": 4}),
    ], final_seq=4, final_msn=0)


def load_fixture() -> dict:
    with open(FIXTURE) as f:
        return json.load(f)


def hard_docs() -> List[MergeTreeDocInput]:
    """The fixture's documents: the hard-semantics set, then the overflow
    document."""
    fx = load_fixture()
    return [doc_from_json(d) for d in fx["hard_docs"]] \
        + [doc_from_json(fx["overflow_doc"])]


def cold_fixture_docs(copies: int) -> List[MergeTreeDocInput]:
    """``copies`` rounds of the fixture's documents that have no base
    summary, each under a new id (``<id>~<round>``)."""
    cold = [d for d in hard_docs() if not d.base_records]
    return [dataclasses.replace(d, doc_id=f"{d.doc_id}~{r}")
            for r in range(copies) for d in cold]


def layout_metas(meta: dict) -> Iterator[Tuple[str, dict]]:
    """``(label, meta copy)`` for every transfer layout a packed chunk's
    facts allow: the widths i8, i16, i32 down from what ``i8_ok`` /
    ``i16_ok`` allow, and each row elision (``ob_rows``, ``ov_rows``,
    ``has_props`` False) either as packed or turned off (rows kept)."""
    widths = ["i32"]
    if meta.get("i16_ok"):
        widths.insert(0, "i16")
        if meta.get("i8_ok"):
            widths.insert(0, "i8")
    rows = [(True,) if meta.get(f, True) else (False, True)
            for f in ("ob_rows", "ov_rows", "has_props")]
    for width, (ob, ov, props) in itertools.product(widths,
                                                    itertools.product(*rows)):
        yield (f"{width}-ob{int(ob)}-ov{int(ov)}-props{int(props)}",
               dict(meta, i16_ok=width != "i32", i8_ok=width == "i8",
                    ob_rows=ob, ov_rows=ov, has_props=props))
