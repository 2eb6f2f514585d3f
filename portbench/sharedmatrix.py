"""The SharedMatrix driver: how a matrix pool reaches the system and is
judged.

The interface is the one ``portbench/sharedstring.py`` documents.  Here:

- ``inputs(pool)``: one ``MatrixDocInput`` a document carrying its binary
  message records and their tables (``MatrixRecords``), with no
  messages: the records are what the port's ingestion writes once;
- ``keep(answer, whole)``: the summary's header facts (``seq``,
  ``minSeq``, ``rows``, ``cols``, ``policy``), or (``whole``) every blob;
- ``CHECKS``: ``header_mismatch`` on every answer (its facts against the
  generator's bookkeeping) and ``grid_mismatch`` on a whole answer (its
  visible grid, each set cell's value by visible row and column, against
  the generator's own final grid);
- ``reference(pool, d, control=False)``: the plain reference's blobs;
- ``ops_of``: messages (a setCell is one, not its two resolve rows);
- ``work(pool, docs)``: the matrix fold's operations and bytes a message,
  by the frozen arithmetic of ``portbench/matrixwork.py``, counted on the
  reference's replay of ``docs``.
"""

from __future__ import annotations

import importlib
import json
from typing import Dict, List, Optional

from . import matrixgen
from .matrixwork import FoldWork, buckets, matrix_fold_bytes
from .reference import sharedmatrix as ref

CHECKS = ("header_mismatch", "grid_mismatch")


def generate(config: dict, traffic: dict, seed: int, n_docs=None,
             n_ops=None) -> matrixgen.MatrixPool:
    return matrixgen.generate(config, traffic, seed, n_docs=n_docs,
                              n_ops=n_ops)


def inputs(pool: matrixgen.MatrixPool) -> List:
    from fluidframework_tpu_torch.ops.matrix_kernel import MatrixDocInput
    from fluidframework_tpu_torch.ops.matrix_native import MatrixRecords

    return [
        MatrixDocInput(doc_id=f"doc{d}", ops=[], final_seq=pool.n_ops,
                       final_msn=pool.final_msn,
                       records=MatrixRecords(**pool.records(d)))
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
    """``(seq, minSeq, rows, cols, policy)`` of a summary header; None
    when it has none."""
    if not header:
        return None
    try:
        h = json.loads(header)
        return h["seq"], h["minSeq"], h["rows"], h["cols"], h["policy"]
    except (ValueError, KeyError, TypeError):
        return None


def keep(answer, whole: bool) -> Optional[Dict]:
    """The answer's header facts, or every blob (``header`` and ``body``
    always present, None when the answer lacks one); None when it is not
    a summary."""
    children = getattr(answer, "children", None)
    if not isinstance(children, dict):
        return None
    if not whole:
        return {"facts": facts(getattr(children.get("header"), "content",
                                       None))}
    out = {name: getattr(child, "content", None)
           for name, child in children.items()}
    out.setdefault("header", None)
    out.setdefault("body", None)
    return out


def ops_of(pool: matrixgen.MatrixPool, d: int) -> int:
    return pool.n_ops


class _Expect:
    """Document ``d``'s header facts, and its visible grid when first
    asked."""

    def __init__(self, pool: matrixgen.MatrixPool, d: int) -> None:
        self.facts = (pool.n_ops, pool.final_msn, int(pool.rows[d]),
                      int(pool.cols[d]), "fww" if pool.fww[d] else "lww")
        self._pool, self._d, self._grid = pool, d, None

    @property
    def grid(self):
        if self._grid is None:
            self._grid = self._pool.final_grid(self._d)
        return self._grid


def expected(pool: matrixgen.MatrixPool, d: int) -> _Expect:
    return _Expect(pool, d)


def visible_grid(body: bytes):
    """A summary body's visible grid as ``final_grid`` writes it:
    ``{(row, col): value}`` by visible position, the cells on removed
    rows or columns left out; None for a body that is not a grid."""
    try:
        obj = json.loads(body)

        def positions(records) -> Dict[int, int]:
            out, handle = {}, 0
            for rec in records:
                for _ in range(rec["n"]):
                    if "rs" not in rec:
                        out[handle] = len(out)
                    handle += 1
            return out

        rows, cols = positions(obj["rows"]), positions(obj["cols"])
        return {(rows[r], cols[c]): v for r, c, v, _s, _cl in obj["cells"]
                if r in rows and c in cols}
    except (ValueError, TypeError, KeyError):
        return None


def faults(expect: _Expect, kept: Dict) -> List[str]:
    out = []
    got = kept["facts"] if "facts" in kept else facts(kept.get("header"))
    if got != expect.facts:
        out.append("header_mismatch")
    if "body" in kept and (kept["body"] is None or visible_grid(
            kept["body"]) != expect.grid):
        out.append("grid_mismatch")
    return out


def reference(pool: matrixgen.MatrixPool, d: int,
              control: bool = False) -> Dict[str, bytes]:
    return ref.replay(pool.records(d), pool.final_msn, control=control)


def work(pool: matrixgen.MatrixPool, docs: List[int]) -> Optional[Dict]:
    """The matrix fold's work a message on ``docs`` caught up as one
    chunk: the reference's replay of each, both streams at the chunk's
    buckets."""
    if not docs:
        return None
    counted = FoldWork()
    for d in docs:
        ref.replay(pool.records(d), pool.final_msn, work=counted)
    S, T = buckets([max(int(pool.row_rows[d]), int(pool.col_rows[d]))
                    for d in docs])
    messages = len(docs) * pool.n_ops
    return {"int_ops_per_op": counted.int_ops / messages,
            "bytes_per_op": matrix_fold_bytes(len(docs), S, T) / messages}


def longest(pool: matrixgen.MatrixPool) -> int:
    """The document with the largest visible grid at the head."""
    return max(range(pool.n_docs),
               key=lambda d: int(pool.rows[d]) * int(pool.cols[d]))
