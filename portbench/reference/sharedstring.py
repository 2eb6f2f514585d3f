"""The plain reference for SharedString catch-up: replay, then summarize.

A frozen copy of the CPU oracle's sequenced path (the merge-tree replica's
``apply_insert`` / ``apply_remove`` / ``apply_annotate``, its visibility
rules, ``normalized_records`` and the ``header`` / ``body`` summary blobs
with their Merkle digest), cut to what a replica needs to replay a
sequenced op log from an empty document: no optimistic local state, no
obliterate, no interval references, no collaboration window above
``min_seq`` 0.  It is plain Python, imports nothing of the system under
test, and reads the generator's plain op records.

Positions resolve in each op's view ``(ref_seq, client)``: a segment
counts its characters iff its insert is visible (``insert_seq <=
ref_seq`` or the same client) and its removal is not.  An insert splits
the segment its position falls inside and goes before the first segment
at or after the position; the first remove of a segment wins, later
removers are recorded as overlap removers; annotates set last-writer-wins
properties (a ``None`` value deletes the key).

``replay(records, control=True)`` is the control: the same replica with
the last sequenced op left out, a summary one op stale, which breaks the
guarantee that every acknowledged op is in the caught-up summary.

``replay(records, work=counter)`` also counts the integer operations the
fold needs on the way (see ``portbench.work``).
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

INSERT, REMOVE, ANNOTATE = 1, 2, 3


class _Seg:
    __slots__ = ("text", "seq", "client", "rseq", "rclient", "overlap",
                 "props")

    def __init__(self, text: str, seq: int, client: str,
                 props: Optional[dict] = None) -> None:
        self.text = text
        self.seq = seq
        self.client = client
        self.rseq: Optional[int] = None
        self.rclient: Optional[str] = None
        self.overlap: set = set()
        self.props = {k: v for k, v in props.items() if v is not None} \
            if props else {}

    def split(self, offset: int) -> "_Seg":
        right = _Seg(self.text[offset:], self.seq, self.client)
        right.rseq, right.rclient = self.rseq, self.rclient
        right.overlap = set(self.overlap)
        right.props = dict(self.props)
        self.text = self.text[:offset]
        return right


def _visible(seg: _Seg, ref_seq: int, client: str) -> int:
    if seg.seq > ref_seq and seg.client != client:
        return 0
    if seg.rseq is not None and (
            seg.rseq <= ref_seq or client == seg.rclient
            or client in seg.overlap):
        return 0
    return len(seg.text)


class Replica:
    """One document's sequenced state: an ordered list of segments."""

    def __init__(self, work=None) -> None:
        self.segs: List[_Seg] = []
        self.seq = 0
        self.work = work

    def _walk(self, start: int, end: int, ref_seq: int, client: str,
              splits: list) -> List[_Seg]:
        """The segments covering visible ``[start, end)``, split at the
        ends; ``splits`` gets the index of each segment split."""
        segs = self.segs
        out = []
        idx, c = 0, 0
        while idx < len(segs) and c < end:
            seg = segs[idx]
            v = _visible(seg, ref_seq, client)
            if v > 0:
                s0, s1 = c, c + v
                lo, hi = max(start, s0), min(end, s1)
                if lo < hi:
                    if lo > s0:
                        segs.insert(idx + 1, seg.split(lo - s0))
                        splits.append(idx)
                        idx += 1
                        seg = segs[idx]
                        s0 = lo
                    if hi < s1:
                        segs.insert(idx + 1, seg.split(hi - s0))
                        splits.append(idx)
                    out.append(seg)
                c += v
            idx += 1
        return out

    def insert(self, pos: int, text: str, seq: int, client: str,
               ref_seq: int, props: Optional[dict] = None) -> None:
        segs = self.segs
        idx, c = 0, 0
        split_at = None
        while idx < len(segs) and c < pos:
            seg = segs[idx]
            v = _visible(seg, ref_seq, client)
            if c + v > pos:
                segs.insert(idx + 1, seg.split(pos - c))
                split_at = idx
                idx += 1
                c = pos
                break
            c += v
            idx += 1
        if c < pos:
            raise ValueError(f"insert pos {pos} beyond view length {c}")
        if self.work is not None:
            self.work.row(INSERT, len(segs),
                          [] if split_at is None else [split_at], idx, 0)
        segs.insert(idx, _Seg(text, seq, client, props))

    def remove(self, start: int, end: int, seq: int, client: str,
               ref_seq: int) -> None:
        splits: list = []
        covered = self._walk(start, end, ref_seq, client, splits)
        if self.work is not None:
            self.work.row(REMOVE, len(self.segs), splits, None, len(covered))
        for seg in covered:
            if seg.rseq is None:
                seg.rseq, seg.rclient = seq, client
            else:
                seg.overlap.add(client)

    def annotate(self, start: int, end: int, props: Dict, seq: int,
                 client: str, ref_seq: int) -> None:
        splits: list = []
        covered = self._walk(start, end, ref_seq, client, splits)
        if self.work is not None:
            self.work.row(ANNOTATE, len(self.segs), splits, None,
                          len(covered))
        for seg in covered:
            for key, value in props.items():
                if value is None:
                    seg.props.pop(key, None)
                else:
                    seg.props[key] = value

    def apply(self, rec: Tuple) -> None:
        kind, seq, client, ref_seq, a, b, text, props = rec
        if kind == INSERT:
            self.insert(a, text, seq, client, ref_seq, props)
        elif kind == REMOVE:
            self.remove(a, b, seq, client, ref_seq)
        elif kind == ANNOTATE:
            self.annotate(a, b, props, seq, client, ref_seq)
        else:
            raise ValueError(f"unknown op kind {kind}")
        self.seq = seq

    def length(self) -> int:
        return sum(len(s.text) for s in self.segs if s.rseq is None)

    def records(self) -> List[dict]:
        """The normalized summary body: sequenced segments in order,
        adjacent runs with identical history merged."""
        out: List[dict] = []
        for seg in self.segs:
            rec = {"t": seg.text, "s": seg.seq, "c": seg.client}
            if seg.rseq is not None:
                rec["rs"] = seg.rseq
                rec["rc"] = seg.rclient
            if seg.overlap:
                rec["ro"] = sorted(seg.overlap)
            if seg.props:
                rec["p"] = dict(sorted(seg.props.items()))
            if out:
                prev = out[-1]
                if all(prev.get(k) == rec.get(k)
                       for k in ("s", "c", "rs", "rc", "ro", "p")):
                    prev["t"] += rec["t"]
                    continue
            out.append(rec)
        return out


def canonical_json(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      ensure_ascii=False).encode("utf-8")


def summary_blobs(replica: Replica, final_seq: int) -> Dict[str, bytes]:
    """The summary's blobs by name: ``header`` and ``body``."""
    header = {"seq": max(replica.seq, final_seq), "minSeq": 0,
              "length": replica.length()}
    return {"header": canonical_json(header),
            "body": canonical_json(replica.records())}


def digest(blobs: Dict[str, bytes]) -> str:
    """The summary tree's Merkle digest over its sorted blob names."""
    h = hashlib.sha256()
    h.update(b"tree\x00")
    for name in sorted(blobs):
        h.update(name.encode("utf-8"))
        h.update(b"\x00")
        h.update(hashlib.sha256(b"blob\x00" + blobs[name]).hexdigest()
                 .encode("ascii"))
        h.update(b"\x00")
    return h.hexdigest()


def replay(records: Sequence[Tuple], final_seq: int, control: bool = False,
           work=None) -> Dict[str, bytes]:
    """Summary blobs of a document caught up from empty over ``records``
    to ``final_seq``; ``control`` leaves the last op out."""
    replica = Replica(work)
    for rec in (records[:-1] if control else records):
        replica.apply(rec)
    if work is not None:
        work.finish(len(replica.segs))
    return summary_blobs(replica, final_seq)
