"""The SharedString driver: how a pool reaches the system and is judged.

A configuration names its driver module; the harness asks it for

- ``generate(config, traffic, seed, n_docs=None, n_ops=None)``: the pool;
- ``inputs(pool)``: the system's document inputs (binary record streams
  with their intern tables, as the native ingestion path hands them over);
- ``entry(traffic)``: the callable one pass drives, ``fn(docs, device,
  stage, stats)`` returning one answer a document;
- ``keep(answer, whole)``: what the harness keeps of an answer from the
  window: its header alone, or (``whole``) every blob; None when the
  answer is not a summary;
- ``ops_of(pool, d)``: the ops an answer for document ``d`` applied;
- ``CHECKS``, ``expected(pool, d)`` and ``faults(expect, kept)``: the
  checks every kept answer gets, by name: its header against the
  generator's bookkeeping, and a whole answer's visible text against the
  text a plain splice of the tail gives;
- ``reference(pool, d, control=False)``: the plain reference's blobs for
  document ``d``, which a sampled answer has to equal byte for byte;
- ``work(pool, docs)``: the fold's operations and bytes an op, counted on
  the reference's replay of ``docs``;
- ``longest(pool)``: the document a sample always holds.
"""

from __future__ import annotations

import importlib
import json
from typing import Dict, List, Optional

from . import generator
from .reference import sharedstring as ref
from .work import FoldWork, export_ops, io_bytes

CHECKS = ("header_mismatch", "text_mismatch")


def generate(config: dict, traffic: dict, seed: int, n_docs=None,
             n_ops=None) -> generator.Pool:
    return generator.generate(config, traffic, seed, n_docs=n_docs,
                              n_ops=n_ops)


def inputs(pool: generator.Pool) -> List:
    from fluidframework_tpu_torch.ops.mergetree_kernel import (
        MergeTreeDocInput)

    return [
        MergeTreeDocInput(
            doc_id=f"doc{d}", ops=[], binary_ops=pool.blobs[d],
            binary_clients=list(pool.clients),
            binary_prop_keys=[pool.prop_key] if pool.values[d] else None,
            binary_values=pool.values[d],
            final_seq=pool.n_ops, final_msn=0)
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


def keep(answer, whole: bool) -> Optional[Dict[str, Optional[bytes]]]:
    """The answer's header blob, or every blob (``body`` always present,
    None when the answer has none); None when it is not a summary."""
    children = getattr(answer, "children", None)
    if not isinstance(children, dict):
        return None
    if not whole:
        return {"header": getattr(children.get("header"), "content", None)}
    out = {name: getattr(child, "content", None)
           for name, child in children.items()}
    out.setdefault("body", None)
    return out


def ops_of(pool: generator.Pool, d: int) -> int:
    return pool.n_ops


class _Expect:
    """Document ``d``'s header, and its visible text when first asked."""

    def __init__(self, pool: generator.Pool, d: int) -> None:
        self.header = pool.header_bytes(d)
        self._pool, self._d, self._text = pool, d, None

    @property
    def text(self) -> bytes:
        if self._text is None:
            self._text = self._pool.final_text(self._d)
        return self._text


def expected(pool: generator.Pool, d: int) -> _Expect:
    return _Expect(pool, d)


def visible_text(body: bytes) -> Optional[bytes]:
    """The text of a summary body's segments that are not removed; None
    for a body that is not a list of segment records."""
    try:
        records = json.loads(body)
        return "".join(r["t"] for r in records if "rs" not in r).encode(
            "utf-8")
    except (ValueError, TypeError, KeyError):
        return None


def faults(expect: _Expect, kept: Dict[str, Optional[bytes]]) -> List[str]:
    out = []
    if kept.get("header") != expect.header:
        out.append("header_mismatch")
    if "body" in kept and (kept["body"] is None
                           or visible_text(kept["body"]) != expect.text):
        out.append("text_mismatch")
    return out


def reference(pool: generator.Pool, d: int,
              control: bool = False) -> Dict[str, bytes]:
    return ref.replay(pool.records(d), pool.n_ops, control=control)


def work(pool: generator.Pool, docs: List[int]) -> Optional[Dict]:
    counter = FoldWork()
    for d in docs:
        ref.replay(pool.records(d), pool.n_ops, work=counter)
    if not counter.rows:
        return None
    return {"int_ops_per_op": (counter.int_ops
                               + export_ops(counter.final_slots))
            / counter.rows,
            "bytes_per_op": io_bytes(counter.rows, counter.final_slots)
            / counter.rows}


def longest(pool: generator.Pool) -> int:
    """The document with the most text at the end of its tail."""
    return int(pool.final_len.argmax())
