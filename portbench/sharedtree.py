"""The SharedTree driver: how a tree pool reaches the system and is judged.

The interface is the one ``portbench/sharedstring.py`` documents.  Here:

- ``inputs(pool)``: one ``TreeDocInput`` a document carrying its binary
  edit records and their tables (``TreeRecords``), with no messages: the
  records are what the port's ingestion writes once;
- ``keep(answer, whole)``: the summary's header facts (``seq``,
  ``minSeq`` and the nodes it emits), or (``whole``) every blob;
- ``CHECKS``: ``header_mismatch`` on every answer (its facts against the
  generator's bookkeeping) and ``forest_mismatch`` on a whole answer (its
  live forest, node ids in order per field with their values, against
  the generator's own final forest);
- ``reference(pool, d, control=False)``: the plain reference's blobs;
- ``work(pool, docs)``: the tree fold's operations and bytes an edit, by
  the frozen arithmetic of ``portbench/treework.py``, counted on the
  reference's replay of ``docs``.
"""

from __future__ import annotations

import importlib
import json
from typing import Dict, List, Optional

from . import treegen
from .reference import sharedtree as ref
from .treework import containers, tree_fold_work

CHECKS = ("header_mismatch", "forest_mismatch")


def generate(config: dict, traffic: dict, seed: int, n_docs=None,
             n_ops=None) -> treegen.TreePool:
    return treegen.generate(config, traffic, seed, n_docs=n_docs,
                            n_ops=n_ops)


def inputs(pool: treegen.TreePool) -> List:
    from fluidframework_tpu_torch.ops.tree_kernel import TreeDocInput
    from fluidframework_tpu_torch.ops.tree_native import TreeRecords

    return [
        TreeDocInput(doc_id=f"doc{d}", ops=[], final_seq=pool.n_ops,
                     final_msn=pool.final_msn,
                     records=TreeRecords(**pool.records(d)))
        for d in range(pool.n_docs)
    ]


def entry(traffic: dict):
    """The traffic's entry (``module:function``), called with its own
    defaults and no cache tiers: every pass folds cold."""
    module, name = traffic["entry"].split(":")
    fn = getattr(importlib.import_module(module), name)

    def cold_pass(docs, device, stage, stats):
        return fn(docs, device=device, stage=stage, stats=stats)

    return cold_pass


def facts(header: Optional[bytes]):
    """``(seq, minSeq, nodes)`` of a summary header, read from its bytes
    (the root's ``minSeq`` and ``seq`` close the canonical JSON; each
    emitted node carries one ``"id":``); None when it has none."""
    if not header:
        return None
    at = header.rfind(b'"minSeq":')
    if at < 0:
        return None
    try:
        tail = json.loads(b"{" + header[at:])
        return tail["seq"], tail["minSeq"], header.count(b'"id":')
    except (ValueError, KeyError):
        return None


def keep(answer, whole: bool) -> Optional[Dict]:
    """The answer's header facts, or every blob (``header`` always
    present, None when the answer has none); None when it is not a
    summary."""
    children = getattr(answer, "children", None)
    if not isinstance(children, dict):
        return None
    if not whole:
        return {"facts": facts(getattr(children.get("header"), "content",
                                       None))}
    out = {name: getattr(child, "content", None)
           for name, child in children.items()}
    out.setdefault("header", None)
    return out


def ops_of(pool: treegen.TreePool, d: int) -> int:
    return pool.n_ops


class _Expect:
    """Document ``d``'s header facts, and its live forest when first
    asked."""

    def __init__(self, pool: treegen.TreePool, d: int) -> None:
        self.facts = (pool.n_ops, pool.final_msn, pool.live_nodes(d))
        self._pool, self._d, self._forest = pool, d, None

    @property
    def forest(self):
        if self._forest is None:
            self._forest = self._pool.final_forest(self._d)
        return self._forest


def expected(pool: treegen.TreePool, d: int) -> _Expect:
    return _Expect(pool, d)


def live_forest(header: bytes):
    """A summary header's live forest as ``final_forest`` writes it:
    ``{field: [(id, value, fields)]}``, nodes with a ``removedSeq`` left
    out with what they hold; None for a header that is not a forest."""
    def fields_of(obj) -> Dict:
        out = {}
        for name, kids in sorted(obj.get("fields", {}).items()):
            live = [(k["id"], k.get("value"), fields_of(k))
                    for k in kids if "removedSeq" not in k]
            if live:
                out[name] = live
        return out

    try:
        return fields_of(json.loads(header))
    except (ValueError, TypeError, KeyError, AttributeError):
        return None


def faults(expect: _Expect, kept: Dict) -> List[str]:
    out = []
    got = kept["facts"] if "facts" in kept else facts(kept.get("header"))
    if got != expect.facts:
        out.append("header_mismatch")
    if "header" in kept and (kept["header"] is None or live_forest(
            kept["header"]) != expect.forest):
        out.append("forest_mismatch")
    return out


def reference(pool: treegen.TreePool, d: int,
              control: bool = False) -> Dict[str, bytes]:
    return ref.replay(pool.records(d), pool.final_msn, control=control)


def work(pool: treegen.TreePool, docs: List[int]) -> Optional[Dict]:
    """The tree fold's work an edit on ``docs`` caught up as one chunk:
    its buckets from their sizes, their real edit rows and the walk steps
    of the reference's replay."""
    if not docs:
        return None
    steps = {"walk_steps": 0}
    for d in docs:
        ref.replay(pool.records(d), pool.final_msn, work=steps)
    sizes = [(int(pool.n_nodes[d]), pool.n_ops) for d in docs]
    n_cont = max(containers(pool.records(d)) for d in docs)
    moved, ops, rows = tree_fold_work(sizes, n_cont, steps["walk_steps"])
    return {"int_ops_per_op": ops / rows, "bytes_per_op": moved / rows}


def longest(pool: treegen.TreePool) -> int:
    """The document with the most nodes at the head."""
    return max(range(pool.n_docs), key=pool.live_nodes)
