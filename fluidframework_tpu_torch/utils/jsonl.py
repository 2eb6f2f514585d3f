"""Crash-safe append-only JSONL primitives shared by the durable stores
(file summary store, op log).

The append-only contract: writers emit one canonical-JSON record plus a
trailing newline per append.  A crash can tear the FINAL line only; torn
non-final lines are corruption and must fail loudly.
"""

from __future__ import annotations

import json
import os


def repair_jsonl_tail(path: str) -> bool:
    """Repair a crash-torn JSONL file IN PLACE before appending resumes.

    A partial final line is truncated away (the crashed append never
    acked); a valid final record missing its trailing newline gets one —
    without this, the next append would MERGE onto it, silently losing the
    new record on the following reopen and corrupting the file for good.
    Returns True if the file was modified.  Torn NON-final lines are left
    for the reader to reject."""
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return False
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        back = min(size, 1 << 20)
        f.seek(size - back)
        tail = f.read()
        if b"\n" not in tail and back < size:
            f.seek(0)
            tail = f.read()
    nl = tail.rfind(b"\n")
    last = tail[nl + 1:]
    if not last.strip():
        return False  # clean EOF (trailing newline present)
    # Records are canonical-JSON OBJECTS (the writers' contract), so a
    # sealable final line must start with '{' AND parse: a torn prefix of
    # an object can never parse, while a torn scalar/array could (e.g.
    # '1234' torn from '123456') — without the prefix check that fragment
    # would be sealed as a valid record (ADVICE r4).
    complete = last.lstrip().startswith(b"{")
    if complete:
        try:
            json.loads(last.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            complete = False
    if not complete:
        with open(path, "r+b") as f:
            f.truncate(size - len(last))
        return True
    with open(path, "ab") as f:  # complete record, torn newline
        f.write(b"\n")
    return True


def iter_jsonl_tolerant(path: str):
    """Yield records; a torn FINAL line (crash mid-append) is dropped so a
    read-only consumer degrades to losing the last record.  A torn line
    anywhere else still raises.  Writers should call
    :func:`repair_jsonl_tail` first instead of relying on this."""
    if not os.path.exists(path):
        return
    pending = None  # one-line lookahead keeps the read streaming
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if pending is not None:
                yield json.loads(pending)  # a torn NON-final line raises
            pending = line
    if pending is not None:
        if not pending.startswith("{"):
            return  # torn fragment of an object record (objects-only contract)
        try:
            yield json.loads(pending)
        except json.JSONDecodeError:
            return
