"""The one traffic generator: SharedString op tails for a whole pool at once.

Every document of a pool gets the same number of ops; the configuration
fixes the pool's size and which documents annotate, the traffic mix fixes
the edit mix and its lengths, and ``--seed`` draws only content: each
position, length, character and property value.  The draws are made one
op index at a time across all documents (numpy), so a pool of millions of
ops takes well under a second or two.

The edit model is beastTest's, as the pinned BASELINE #1 workload draws it:
clients ``0..clients-1`` round robin, each op's ``ref_seq`` one behind its
``seq`` (``min_seq`` 0); an insert of ``insert_len`` characters from
``alphabet`` at a uniform position, or a remove / annotate of a uniform
start and ``range_len`` characters clipped at the end; while a document is
shorter than ``min_len_for_range`` every op inserts.  Documents that do
not annotate turn the annotate share into removes.

``Pool.blobs`` are the native binary record streams
(``<B8i`` header: kind, seq, ref_seq, min_seq, client, a, b, pair count,
text bytes; then ``<2i`` (key, value) pairs; then the text), written with
doc-local intern tables exactly as the port's record encoder writes them:
clients, property keys and values numbered by first appearance.
``Pool.records(d)`` gives document ``d``'s plain op records for the
reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

INSERT, REMOVE, ANNOTATE = 1, 2, 3

_HEADER = np.dtype([("kind", "u1"), ("seq", "<i4"), ("ref_seq", "<i4"),
                    ("min_seq", "<i4"), ("client", "<i4"), ("a", "<i4"),
                    ("b", "<i4"), ("n_pairs", "<i4"), ("text_len", "<i4")])
assert _HEADER.itemsize == 33
#: the widest tail a record can carry: 8 text bytes, or one (key, value)
#: pair; the traffic's ``insert_len`` may not exceed it
_TAIL = 8
_BLOCK_DOCS = 256


@dataclasses.dataclass
class Pool:
    """A generated pool: ``[D, T]`` op arrays (doc-major), the inserted
    characters, each document's final visible length and its binary
    stream with intern tables."""

    kind: np.ndarray        # [D, T] int8: INSERT / REMOVE / ANNOTATE
    a: np.ndarray           # [D, T] int32: insert pos, or range start
    b: np.ndarray           # [D, T] int32: range end (0 for inserts)
    text_len: np.ndarray    # [D, T] int32: inserted characters
    chars: np.ndarray       # [D, T, 8] uint8: the inserted text first
    value: np.ndarray       # [D, T] int32: annotate value (-1 otherwise)
    final_len: np.ndarray   # [D] int64: visible length after the tail
    annotating: np.ndarray  # [D] bool
    clients: List[str]
    prop_key: str
    blobs: List[bytes]
    values: List[Optional[List[int]]]   # per document, first appearance

    @property
    def n_docs(self) -> int:
        return int(self.kind.shape[0])

    @property
    def n_ops(self) -> int:
        return int(self.kind.shape[1])

    def records(self, d: int) -> List[Tuple]:
        """Document ``d``'s ops as plain records ``(kind, seq, client,
        ref_seq, a, b, text, props)``, ``props`` a dict or None."""
        out = []
        n_clients = len(self.clients)
        for i in range(self.n_ops):
            k = int(self.kind[d, i])
            text = ""
            props = None
            if k == INSERT:
                text = bytes(self.chars[d, i, :self.text_len[d, i]]).decode(
                    "ascii")
            elif k == ANNOTATE:
                props = {self.prop_key: int(self.value[d, i])}
            out.append((k, i + 1, self.clients[i % n_clients], i,
                        int(self.a[d, i]), int(self.b[d, i]), text, props))
        return out

    def final_text(self, d: int) -> bytes:
        """Document ``d``'s visible text after its tail, spliced op by op
        into a plain byte string (each op sees every earlier one)."""
        text = bytearray()
        chars = self.chars[d].tobytes()
        for i, (k, a, b, n) in enumerate(zip(
                self.kind[d].tolist(), self.a[d].tolist(),
                self.b[d].tolist(), self.text_len[d].tolist())):
            if k == INSERT:
                text[a:a] = chars[i * _TAIL:i * _TAIL + n]
            elif k == REMOVE:
                del text[a:b]
        return bytes(text)

    def header_bytes(self, d: int) -> bytes:
        """The summary header every correct fold of document ``d`` writes
        (canonical JSON: sorted keys, no spaces)."""
        return (f'{{"length":{int(self.final_len[d])},"minSeq":0,'
                f'"seq":{self.n_ops}}}').encode("ascii")


def generate(config: dict, traffic: dict, seed: int,
             n_docs: Optional[int] = None,
             n_ops: Optional[int] = None) -> Pool:
    """The pool of ``config`` under ``traffic`` for ``seed``; ``n_docs`` /
    ``n_ops`` override the configuration's counts (tests only)."""
    D = int(n_docs if n_docs is not None else config["docs"])
    T = int(n_ops if n_ops is not None else config["ops_per_doc"])
    mix = traffic["edit_mix"]
    p_insert = float(mix["insert"])
    p_remove = float(mix["remove"])
    ins_lo, ins_hi = traffic["insert_len"]
    rng_lo, rng_hi = traffic["range_len"]
    if not 1 <= ins_lo <= ins_hi <= _TAIL:
        raise ValueError(f"insert_len must lie in [1, {_TAIL}]")
    alphabet = np.frombuffer(traffic["alphabet"].encode("ascii"), np.uint8)
    min_len = int(traffic["min_len_for_range"])
    n_values = int(traffic["prop_values"])
    mod, at_least = config["annotating_docs"]["mod"], \
        config["annotating_docs"]["at_least"]
    annotating = (np.arange(D) % mod) >= at_least

    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 0x5EED])
    # Every draw is made up front, whatever each op turns out to be, so
    # the stream of random numbers never depends on the content; the
    # positions scale uniform floats by the length each op sees.
    r = rng.random((T, D))
    u_pos = rng.random((T, D))
    u_start = rng.random((T, D))
    n = rng.integers(ins_lo, ins_hi + 1, (T, D), dtype=np.int32)
    span = rng.integers(rng_lo, rng_hi + 1, (T, D), dtype=np.int32)
    val = rng.integers(0, n_values, (T, D), dtype=np.int32)
    kind = np.empty((T, D), np.int8)
    a = np.empty((T, D), np.int32)
    b = np.zeros((T, D), np.int32)
    tlen = np.zeros((T, D), np.int32)
    value = np.full((T, D), -1, np.int32)
    length = np.zeros(D, np.int64)
    for i in range(T):
        ins = (r[i] < p_insert) | (length < min_len)
        rem = ~ins & ((r[i] < p_insert + p_remove) | ~annotating)
        ann = ~ins & ~rem
        pos = (u_pos[i] * (length + 1)).astype(np.int64)
        start = (u_start[i] * np.maximum(length - 1, 1)).astype(np.int64)
        end = np.minimum(length, start + span[i])
        kind[i] = np.where(ins, INSERT, np.where(rem, REMOVE, ANNOTATE))
        a[i] = np.where(ins, pos, start)
        b[i] = np.where(ins, 0, end)
        tlen[i] = np.where(ins, n[i], 0)
        value[i] = np.where(ann, val[i], -1)
        length += np.where(ins, n[i], np.where(rem, start - end, 0))
    # bytes past an insert's length are never read
    chars = alphabet[rng.integers(0, len(alphabet), (D, T, _TAIL),
                                  dtype=np.uint8)]
    pool = Pool(kind=np.ascontiguousarray(kind.T), a=np.ascontiguousarray(a.T),
                b=np.ascontiguousarray(b.T), text_len=np.ascontiguousarray(
                    tlen.T), chars=chars, value=np.ascontiguousarray(value.T),
                final_len=length, annotating=annotating,
                clients=[f"client{c}" for c in range(int(config["clients"]))],
                prop_key=traffic["prop_key"], blobs=[], values=[])
    pool.blobs, pool.values = encode_pool(pool)
    return pool


def _value_ids(value: np.ndarray) -> Tuple[np.ndarray, List]:
    """Doc-local value ids by first appearance (the encoder's interning),
    and each document's value table (None when it annotates nothing)."""
    D, T = value.shape
    ids = np.full((D, T), -1, np.int32)
    tables: List[Optional[List[int]]] = [None] * D
    n_values = int(value.max()) + 1 if value.size and value.max() >= 0 else 0
    if n_values == 0:
        return ids, tables
    # first op index at which each (doc, value) appears (T if never)
    first = np.full((D, n_values), T, np.int64)
    d_idx, t_idx = np.nonzero(value >= 0)
    np.minimum.at(first, (d_idx, value[d_idx, t_idx]), t_idx)
    order = np.argsort(first, axis=1, kind="stable")
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(n_values)[None, :], axis=1)
    ids[d_idx, t_idx] = rank[d_idx, value[d_idx, t_idx]]
    present = first < T
    for d in np.nonzero(present.any(axis=1))[0]:
        tables[d] = [int(v) for v in order[d] if present[d, v]]
    return ids, tables


def encode_pool(pool: Pool) -> Tuple[List[bytes], List]:
    """Every document's binary record stream, a block of documents at a
    time: one 41-byte row a record (header, then text or the pair), and
    the rows compacted to their true lengths."""
    D, T = pool.kind.shape
    vid, tables = _value_ids(pool.value)
    blobs: List[bytes] = []
    seq = np.arange(1, T + 1, dtype=np.int32)
    client = (np.arange(T) % len(pool.clients)).astype(np.int32)
    for lo in range(0, D, _BLOCK_DOCS):
        hi = min(D, lo + _BLOCK_DOCS)
        B = hi - lo
        kind = pool.kind[lo:hi]
        ann = kind == ANNOTATE
        hdr = np.zeros((B, T), _HEADER)
        hdr["kind"] = kind
        hdr["seq"] = seq
        hdr["ref_seq"] = seq - 1
        hdr["client"] = client
        hdr["a"] = pool.a[lo:hi]
        hdr["b"] = pool.b[lo:hi]
        hdr["n_pairs"] = ann
        hdr["text_len"] = pool.text_len[lo:hi]
        rows = np.zeros((B, T, _HEADER.itemsize + _TAIL), np.uint8)
        rows[:, :, :_HEADER.itemsize] = hdr.view(np.uint8).reshape(
            B, T, _HEADER.itemsize)
        pair = np.zeros((B, T, 2), "<i4")
        pair[:, :, 1] = vid[lo:hi]
        tail = np.where(ann[:, :, None], pair.view(np.uint8).reshape(B, T, 8),
                        pool.chars[lo:hi])
        rows[:, :, _HEADER.itemsize:] = tail
        size = _HEADER.itemsize + pool.text_len[lo:hi] + 8 * ann
        keep = np.arange(_HEADER.itemsize + _TAIL)[None, None, :] \
            < size[:, :, None]
        flat = rows[keep]
        ends = np.cumsum(size.sum(axis=1))
        starts = ends - size.sum(axis=1)
        blobs.extend(flat[s:e].tobytes() for s, e in zip(starts, ends))
    return blobs, tables
