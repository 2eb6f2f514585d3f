"""Service-shaped corpora for the port's ``CatchupService``, with no JAX
import.

Copies of the reference's corpus builders, built on the port's own
generators:

- ``build_catchup_corpus`` / ``catchup_oracle_digest`` — ``bench.py``'s:
  single-string documents, an empty seeded summary at seq 0 plus the
  pinned ``synth_doc`` op tail appended to the op log in the runtime's
  groupedBatch envelope, and the CPU container fold that judges them;
- ``build_tree_catchup_corpus`` — ``tools/bench_kernels.py``'s tree twin
  (``synth_tree_messages`` tails);
- ``drive_mixed_doc`` — the mixed five-channel traffic driver of the
  reference's service tests, over live container runtimes.

Added for the card: ``build_catchup_corpus(..., attribution=True)``
seeds attribution-enabled documents whose window clamps their inserts,
``grow_catchup_corpus(..., grow_every=)`` grows every Nth document's tail
along the same stream, ``build_mixed_corpus`` seeds the mixed
documents with two connected runtimes each, and ``write_catchup_corpus``
writes the same single-string documents through a server's or a front
door's RPC (one connected writer a document, the pinned ``synth_doc``
contents, batched ingress; ``growth_plan`` continues them).
"""

from __future__ import annotations

import random
from typing import Dict, List

from ..protocol.messages import MessageType, SequencedMessage
from ..protocol.summary import SummaryTree
from ..runtime.container import ContainerRuntime, ContainerRuntimeOptions
from .tree_workload import synth_tree_messages
from .workload import doc_ops, synth_doc

#: how far the minimum sequence number trails each op of an attribution
#: document: every insert more than this many ops before the head clamps
#: to seq 0 in the summary body and keeps its author in the key blob.
ATTRIBUTION_WINDOW = 16


def _seed_summary(type_name: str, channel_id: str,
                  attribution: bool = False) -> SummaryTree:
    seeded = ContainerRuntime(
        options=ContainerRuntimeOptions(attribution=attribution))
    seeded.create_datastore("ds").create_channel(type_name, channel_id)
    return seeded.summarize()


def _grouped(m: SequencedMessage, channel_id: str,
             min_seq: int) -> SequencedMessage:
    """One channel op in the groupedBatch container envelope."""
    return SequencedMessage(
        seq=m.seq, client_id=m.client_id, client_seq=m.client_seq,
        ref_seq=m.ref_seq, min_seq=min_seq, type=MessageType.OP,
        contents={"type": "groupedBatch", "ops": [
            {"ds": "ds", "channel": channel_id,
             "clientSeq": m.client_seq,
             "contents": m.contents}]},
    )


def _string_min_seq(m: SequencedMessage, attribution: bool) -> int:
    if attribution:
        return max(0, m.seq - ATTRIBUTION_WINDOW)
    return m.min_seq


def build_catchup_corpus(service, n_docs: int, ops_per_doc: int,
                         attribution: bool = False) -> List[str]:
    """Seed ``service`` with ``n_docs`` single-string documents: an empty
    seeded summary at seq 0 plus the PINNED synth_doc op tail appended
    straight to the op log (each op wrapped in the groupedBatch container
    envelope the runtime emits) — the service-shaped twin of the bench
    corpus, cheap enough to build at full scale.  ``attribution`` stamps
    the seeded summary attribution-enabled and lets the minimum sequence
    number trail each op by :data:`ATTRIBUTION_WINDOW`.  Returns the doc
    ids."""
    seed_tree = _seed_summary("sequence-tpu", "text", attribution)
    doc_ids = []
    for i in range(n_docs):
        doc_id = f"cdoc{i}"
        service.storage.upload(doc_id, seed_tree, 0)
        for m in doc_ops(synth_doc(i, ops_per_doc)):
            service.oplog.append(doc_id, _grouped(
                m, "text", _string_min_seq(m, attribution)))
        doc_ids.append(doc_id)
    return doc_ids


def grow_catchup_corpus(service, doc_ids: List[str], ops_per_doc: int,
                        grown_ops: int, grow_every: int = 8) -> List[str]:
    """Append ops ``ops_per_doc + 1 .. grown_ops`` of the same pinned
    stream to every ``grow_every``-th document of a
    :func:`build_catchup_corpus` corpus (the first, then every Nth), the
    warm path's grown tails.  Returns the grown doc ids."""
    grown = []
    for i, doc_id in enumerate(doc_ids):
        if i % grow_every:
            continue
        for m in doc_ops(synth_doc(i, grown_ops))[ops_per_doc:]:
            service.oplog.append(doc_id, _grouped(m, "text", m.min_seq))
        grown.append(doc_id)
    return grown


def catchup_oracle_digest(service, doc_id: str) -> str:
    """CPU container fold of one corpus doc — the byte-identity oracle
    for the catch-up service."""
    runtime = ContainerRuntime()
    summary, ref_seq = service.storage.latest(doc_id)
    runtime.load(summary)
    for msg in service.oplog.get(doc_id, from_seq=ref_seq):
        runtime.process(msg)
    return runtime.summarize().digest()


def build_tree_catchup_corpus(service, n_docs: int,
                              n_edits: int) -> List[str]:
    """Seed ``service`` with tree-channel documents: an empty seeded
    summary plus the pinned tree changeset tails appended to the op log
    in the runtime's groupedBatch envelope — the service-shaped twin of
    the tree bench corpus (mirrors :func:`build_catchup_corpus`)."""
    seed_tree = _seed_summary("tree-tpu", "tree")
    doc_ids = []
    for i in range(n_docs):
        doc_id = f"ctdoc{i}"
        service.storage.upload(doc_id, seed_tree, 0)
        for m in synth_tree_messages(i, n_edits):
            service.oplog.append(doc_id, _grouped(m, "tree", m.min_seq))
        doc_ids.append(doc_id)
    return doc_ids


def drive_mixed_doc(runtimes, rng, rounds=6):
    """Random traffic across all channels of the mixed-type datastore."""
    for i in range(rounds):
        rt = runtimes[i % len(runtimes)]
        ds = rt.get_datastore("ds")
        roll = rng.random()
        if roll < 0.3:
            t = ds.get_channel("text")
            L = len(t.text)
            if L < 4 or rng.random() < 0.7:
                t.insert_text(rng.randint(0, L), "xy"[i % 2] * 2)
            else:
                s = rng.randint(0, L - 2)
                t.remove_range(s, min(L, s + 2))
        elif roll < 0.5:
            ds.get_channel("kv").set(f"k{rng.randint(0, 5)}",
                                     rng.randint(0, 99))
        elif roll < 0.7:
            m = ds.get_channel("grid")
            if m.row_count == 0 or rng.random() < 0.4:
                m.insert_rows(rng.randint(0, m.row_count), 1)
            elif m.col_count == 0 or rng.random() < 0.6:
                m.insert_cols(rng.randint(0, m.col_count), 1)
            else:
                m.set_cell(rng.randint(0, m.row_count - 1),
                           rng.randint(0, m.col_count - 1),
                           rng.randint(0, 99))
        elif roll < 0.9:
            tr = ds.get_channel("tree")
            from ..dds.tree import ROOT_ID
            kids = tr.children(ROOT_ID, "a")
            if not kids or rng.random() < 0.7:
                tr.insert(ROOT_ID, "a", rng.randint(0, len(kids)),
                          [tr.build("n", value=rng.randint(0, 9))])
            else:
                tr.set_value(rng.choice(kids), rng.randint(0, 99))
        else:
            ds.get_channel("clicks").increment(1)
        for r in runtimes:
            r.drain()


MIXED_CHANNELS = (("sequence-tpu", "text"), ("map-tpu", "kv"),
                  ("matrix-tpu", "grid"), ("tree-tpu", "tree"),
                  ("counter-tpu", "clicks"))


def build_mixed_corpus(service, n_docs: int, rng: random.Random,
                       rounds: int = 8) -> Dict[str, list]:
    """Seed ``service`` with ``n_docs`` documents of one datastore holding
    a string, a map, a matrix, a tree and a counter channel, connect
    two live runtimes to each and drive ``rounds`` of
    :func:`drive_mixed_doc` traffic (the reference's mixed-types service
    scenario).  Returns ``{doc_id: runtimes}`` so callers drive more
    rounds between catch-ups."""
    all_runtimes = {}
    for d in range(n_docs):
        doc_id = f"mixed{d}"
        ep = service.create_document(doc_id)
        seeded = ContainerRuntime()
        ds = seeded.create_datastore("ds")
        for type_name, channel_id in MIXED_CHANNELS:
            ds.create_channel(type_name, channel_id)
        service.storage.upload(doc_id, seeded.summarize(), 0)
        runtimes = []
        for c in range(2):
            rt = ContainerRuntime()
            rt.load(service.storage.latest(doc_id)[0])
            rt.connect(ep, f"client{c}")
            rt.drain()
            runtimes.append(rt)
        all_runtimes[doc_id] = runtimes
        drive_mixed_doc(runtimes, rng, rounds=rounds)
    return all_runtimes


#: the one writer of a document written through RPC
RPC_WRITER = "w"


def raw_string_op(contents: dict, client_seq: int, ref_seq: int) -> dict:
    """One ``synth_doc`` op as the RPC writer's raw op on the wire, in the
    runtime's groupedBatch envelope."""
    from ..protocol.messages import RawOperation
    from ..protocol.wire import encode_raw_operation

    return encode_raw_operation(RawOperation(
        client_id=RPC_WRITER, client_seq=client_seq, ref_seq=ref_seq,
        type=MessageType.OP,
        contents={"type": "groupedBatch", "ops": [
            {"ds": "ds", "channel": "text", "clientSeq": client_seq,
             "contents": contents}]}))


def _submit_ops(rpc, plan: Dict[str, list], batch_docs: int,
                timeout: float) -> None:
    """``plan``: doc -> [(contents, client_seq, ref_seq)], submitted in
    ``submit_mixed`` calls of ``batch_docs`` documents; raises unless
    every op of every document was stamped."""
    docs = sorted(plan)
    for lo in range(0, len(docs), batch_docs):
        part = docs[lo:lo + batch_docs]
        out = rpc.request("submit_mixed", {"batches": {
            d: [raw_string_op(*row) for row in plan[d]] for d in part}},
            timeout=timeout)
        for d in part:
            got = out.get(d) or {}
            if got.get("error") or got.get("stamped") != len(plan[d]):
                raise RuntimeError(f"{d}: submit_mixed stamped "
                                   f"{got.get('stamped')} of "
                                   f"{len(plan[d])} ops: {got}")


def write_catchup_corpus(rpc, n_docs: int, ops_per_doc: int,
                         prefix: str = "fdoc", batch_docs: int = 64,
                         timeout: float = 120.0) -> List[str]:
    """Create ``n_docs`` single-string documents through ``rpc`` (an
    ``_RpcClient`` of a server or a front door): each with the empty
    seeded summary at seq 0, its writer connected (the JOIN is seq 1),
    then the PINNED ``synth_doc(i, ops_per_doc)`` contents as the
    writer's ops (op ``j`` lands at seq ``j + 2`` and refers to seq
    ``j + 1``, so each sees every op before it) through batched
    ingress.  Returns the doc ids."""
    from ..protocol.summary import tree_to_obj

    seed = tree_to_obj(_seed_summary("sequence-tpu", "text"))
    doc_ids, plan = [], {}
    for i in range(n_docs):
        doc_id = f"{prefix}{i}"
        rpc.request("create_document", {"doc": doc_id, "summary": seed,
                                        "ref_seq": 0}, timeout=timeout)
        rpc.request("connect", {"doc": doc_id, "client": RPC_WRITER},
                    timeout=timeout)
        plan[doc_id] = [(m.contents, j + 1, j + 1) for j, m in enumerate(
            doc_ops(synth_doc(i, ops_per_doc)))]
        doc_ids.append(doc_id)
    _submit_ops(rpc, plan, batch_docs, timeout)
    return doc_ids


def growth_plan(doc_ids: List[str], ops_per_doc: int,
                grown_ops: int) -> Dict[str, list]:
    """Ops ``ops_per_doc .. grown_ops - 1`` of each document's pinned
    stream (``doc_ids[i]`` is ``synth_doc(i, ...)``) as
    ``(contents, client_seq, ref_seq)`` rows continuing the writer's
    sequence of :func:`write_catchup_corpus`."""
    plan = {}
    for i, doc_id in enumerate(doc_ids):
        ops = doc_ops(synth_doc(i, grown_ops))
        plan[doc_id] = [(ops[j].contents, j + 1, j + 1)
                        for j in range(ops_per_doc, grown_ops)]
    return plan
