"""File driver: a durable single-host deployment of the whole service.

Capability parity with the reference's file-driver + Historian/gitrest
storage (SURVEY.md §2.3/§2.4: summaries stored as content-addressed
objects — literally git's blob/tree model — plus per-document commit
history).  Everything lives under one directory:

    <root>/ops.jsonl          — the durable op log (OpLog format)
    <root>/objects/<digest>   — content-addressed summary nodes (JSON)
    <root>/commits.jsonl      — commit-chain records (doc, handle, refSeq,
                                parent, message) — git-style history
    <root>/refs.jsonl         — ref updates (doc, ref, commit); last wins

Reopening the directory restores the full service: documents recover from
the op log, summaries + commit history + refs from the object store."""

from __future__ import annotations

import base64
import json
import os
import threading
from typing import Optional, Union

from ..protocol.summary import (
    SummaryBlob,
    SummaryCommit,
    SummaryStorage,
    SummaryTree,
)
from ..utils.jsonl import iter_jsonl_tolerant, repair_jsonl_tail
from ..service.oplog import OpLog
from ..service.orderer import LocalOrderingService
from .local_driver import LocalDocumentServiceFactory


_iter_jsonl = iter_jsonl_tolerant


def _append_jsonl(path: str, rec: dict) -> None:
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")


def _serialize_node(node: Union[SummaryTree, SummaryBlob]) -> bytes:
    if isinstance(node, SummaryBlob):
        obj = {"kind": "blob",
               "content": base64.b64encode(node.content).decode("ascii")}
    else:
        obj = {"kind": "tree",
               "children": {name: child.digest()
                            for name, child in sorted(node.children.items())}}
    return json.dumps(obj, sort_keys=True).encode("utf-8")


class FileSummaryStorage(SummaryStorage):
    """Content-addressed summary store persisted to a directory.

    Durability discipline (SEMANTICS.md "Durability & retry"): object
    writes are write-then-rename (a reader can never observe a partial
    object), crash-orphaned ``.tmp`` files are swept on reopen, and cold
    loads verify the content digest against the handle — a corrupt object
    file is QUARANTINED (moved aside, surfaced as the missing-handle
    ``KeyError`` contract) rather than served or crashed on.  ``faults``
    (a ``testing.faults.FaultInjector``) arms the ``storage.store`` /
    ``storage.read`` fault sites."""

    def __init__(self, root: str, faults=None) -> None:
        super().__init__()
        self.root = root
        self._faults = faults
        self._objects_dir = os.path.join(root, "objects")
        self._quarantine_dir = os.path.join(root, "quarantine")
        self._commits_path = os.path.join(root, "commits.jsonl")
        self._refs_path = os.path.join(root, "refs.jsonl")
        os.makedirs(self._objects_dir, exist_ok=True)
        # Crash hygiene: a publish that died between tmp-write and rename
        # leaves an orphan no read can ever reach — sweep, don't accrete.
        for name in sorted(os.listdir(self._objects_dir)):
            if ".tmp." in name:
                try:
                    os.remove(os.path.join(self._objects_dir, name))
                except OSError:
                    pass
        # Persist the storage epoch: a reopened store keeps its generation;
        # a wiped/recreated directory mints a new one (odsp EpochTracker).
        # Written ATOMICALLY (temp + rename), and an empty file — a crash
        # between create and write — is rewritten rather than silently
        # minting a fresh epoch on every restart.
        self._epoch_path = os.path.join(root, "epoch")
        stored = ""
        if os.path.exists(self._epoch_path):
            with open(self._epoch_path, "r", encoding="utf-8") as f:
                stored = f.read().strip()
        if stored:
            self.epoch = stored
        else:
            self._persist_epoch()
        # Repair crash-torn tails BEFORE appends resume: without this the
        # next append merges onto a torn line, silently losing the new
        # record on the following reopen.
        repair_jsonl_tail(self._commits_path)
        repair_jsonl_tail(self._refs_path)
        for rec in _iter_jsonl(self._commits_path):
            # Rebuild the commit chain.  Old-format records carry no
            # "parent" field: chain them linearly onto the doc's rebuilt
            # head (exactly how they were written).
            parent = rec.get("parent", self.head(rec["doc"]))
            self._record_commit(SummaryCommit(
                doc_id=rec["doc"], tree=rec["handle"],
                parent=parent, ref_seq=rec["refSeq"],
                message=rec.get("message", ""),
            ))
        for rec in _iter_jsonl(self._refs_path):
            # Last record wins per (doc, ref).  Same validation create_ref
            # enforces: a pin whose commit never made it to commits.jsonl
            # (torn write) is dropped rather than left to KeyError readers.
            if rec["commit"] in self._commit_objects:
                self._set_ref(rec["doc"], rec["ref"], rec["commit"])
        #: refresh_doc memo: (commits, refs) file sizes already ingested
        self._chain_sizes = self._chain_file_sizes()  # guarded-by: _lock

    def _persist_epoch(self) -> None:
        tmp_path = self._epoch_path + ".tmp"
        with open(tmp_path, "w", encoding="utf-8") as f:
            f.write(self.epoch)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_path, self._epoch_path)  # commit-point: epoch publish
        # fsync the DIRECTORY too: the rename itself must be durable,
        # or a crash could lose the epoch file and a reopen would mint
        # a new generation for a store whose data survived.
        dfd = os.open(self.root, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def bump_epoch(self, token: str) -> str:
        """Generation fence, persisted: a restart after a shard failover
        must reopen into the POST-fence generation, or clients that
        already reconnected through the fence would be told their fresh
        caches are stale (or worse, pre-fence pins would validate)."""
        super().bump_epoch(token)
        self._persist_epoch()
        return token

    def _chain_file_sizes(self) -> tuple:
        def size(path):
            try:
                return os.path.getsize(path)
            except OSError:
                return 0
        return (size(self._commits_path), size(self._refs_path))

    def refresh_doc(self, doc_id: str) -> None:
        """Merge commit-chain records other PROCESSES appended to the
        shared files (fluidproc adoption/migration): in the
        out-of-process tier every shard host holds its own instance over
        the SAME root, and a document's chain is appended by its single
        owner — when ownership moves, the new owner's in-memory view is
        stale for exactly the moved documents.  Append-only files + one
        writer per document (the freeze/kill precedes the move) make
        this a pure catch-up read: known records skip by digest, the
        last ref record wins.

        The scan ingests EVERY document's new records (not just
        ``doc_id``) and memoizes by file size, so a mass failover pays
        ONE file pass for its whole adoption wave instead of one per
        document; own-instance uploads keep the memo current."""
        with self._lock:
            sizes = self._chain_file_sizes()
            if sizes == getattr(self, "_chain_sizes", None):
                return
            replay_heads: dict = {}
            for rec in _iter_jsonl(self._commits_path):
                doc = rec["doc"]
                parent = rec.get("parent",
                                 replay_heads.get(doc, self.head(doc)))
                commit = SummaryCommit(
                    doc_id=doc, tree=rec["handle"], parent=parent,
                    ref_seq=rec["refSeq"], message=rec.get("message", ""),
                )
                digest = commit.digest()
                replay_heads[doc] = digest
                if digest not in self._commit_objects:
                    self._record_commit(commit)
            for rec in _iter_jsonl(self._refs_path):
                if rec["commit"] in self._commit_objects:
                    self._set_ref(rec["doc"], rec["ref"], rec["commit"])
            self._chain_sizes = sizes

    # -- persistence hooks -----------------------------------------------------

    def upload(self, doc_id: str, tree: SummaryTree, ref_seq: int,
               message: str = "") -> str:
        with self._lock:  # chain update + durable record stay one unit
            handle = super().upload(doc_id, tree, ref_seq, message=message)
            # Persist the commit the base class actually recorded (it is
            # the new head) — never a parallel reconstruction that could
            # diverge.
            commit = self.read_commit(self.head(doc_id))
            _append_jsonl(self._commits_path, {
                "doc": commit.doc_id, "handle": commit.tree,
                "refSeq": commit.ref_seq, "parent": commit.parent,
                "message": commit.message,
            })  # commit-point: summary commit record
            # Deliberately NOT refreshing the scan memo here: the file
            # size now also covers bytes OTHER processes appended since
            # our last scan, and marking those as seen would make the
            # next refresh skip records it never ingested (an adopted
            # doc's summary chain would silently vanish).  An own append
            # merely costs the next refresh one re-scan.
            return handle

    def create_ref(self, doc_id: str, name: str, commit_digest: str) -> None:
        with self._lock:
            super().create_ref(doc_id, name, commit_digest)
            _append_jsonl(self._refs_path,
                          {"doc": doc_id, "ref": name,
                           "commit": commit_digest})  # commit-point: ref pin record

    def _store(self, node: Union[SummaryTree, SummaryBlob]) -> str:
        digest = super()._store(node)
        path = os.path.join(self._objects_dir, digest)
        if not os.path.exists(path):  # content-addressed: write-once
            fault = (self._faults.fire("storage.store")
                     if self._faults is not None else None)
            # Atomic publish: executor-thread uploads run concurrently
            # with event-loop reads of the same content-addressed object —
            # a reader must never observe a partially-written file.
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            if fault is not None:
                self._faulted_store(fault, tmp, node)
            with open(tmp, "wb") as f:
                f.write(_serialize_node(node))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # commit-point: summary object publish
        return digest

    def _faulted_store(self, fault, tmp: str,
                       node: Union[SummaryTree, SummaryBlob]) -> None:
        """Injected upload failure: ``fail`` dies before any bytes,
        ``torn`` leaves a partial ``.tmp`` (the pre-rename crash shape —
        never visible to reads, swept on reopen).  Either way the object
        file does not exist and the upload surfaces an OSError the
        caller's retry re-publishes cleanly."""
        from ..testing.faults import FaultError

        if fault.kind == "torn":
            data = _serialize_node(node)
            frac = fault.arg if 0.0 < fault.arg < 1.0 else 0.5
            with open(tmp, "wb") as f:
                f.write(data[:max(1, int(len(data) * frac))])
                f.flush()
                os.fsync(f.fileno())
        raise FaultError("storage.store", fault.kind)

    # -- lazy reads from disk (latest() inherits these via read()) -------------

    def read(self, handle: str) -> Union[SummaryTree, SummaryBlob]:
        # Probe / load / publish, each a SINGLE critical section (the
        # begin/publish shape of the orderer's single-flight recovery):
        # the disk read happens OUTSIDE the lock — holding the store-wide
        # lock across I/O would serialize every head()/upload() behind
        # one cold load.  Content-addressing makes the load race benign:
        # two threads loading the same handle produce identical nodes,
        # and the publish's setdefault atomically re-validates so exactly
        # one survives.
        cached = self._probe_memo(handle)
        if cached is not None:
            return cached
        return self._publish_memo(handle, self._load_from_disk(handle))

    def _probe_memo(self, handle: str
                    ) -> Optional[Union[SummaryTree, SummaryBlob]]:
        with self._lock:
            return self._objects.get(handle)

    def _publish_memo(self, handle: str,
                      node: Union[SummaryTree, SummaryBlob]
                      ) -> Union[SummaryTree, SummaryBlob]:
        """One atomic claim: install-or-adopt — a racing duplicate load
        loses to whichever byte-identical node published first."""
        with self._lock:
            return self._objects.setdefault(handle, node)

    def latest_with_handle(self, doc_id: str, at_or_below: int = None):
        fault = (self._faults.fire("storage.read", doc=doc_id)
                 if self._faults is not None else None)
        if fault is not None and fault.kind == "fail":
            from ..testing.faults import FaultError

            raise FaultError("storage.read", "fail", doc_id)
        if fault is not None and fault.kind == "stale":
            # A lagging replica: serve the PARENT summary when one exists
            # — the client replays a longer op tail and must converge to
            # the same state (the catch-up path's whole correctness
            # claim; pinned by the chaos oracle).
            newest = True
            for commit in self._walk(self.head(doc_id)):
                if at_or_below is not None and commit.ref_seq > at_or_below:
                    continue
                if newest and commit.parent is not None:
                    newest = False
                    continue
                return self.read(commit.tree), commit.ref_seq, commit.tree
            return None, 0, None
        return super().latest_with_handle(doc_id, at_or_below=at_or_below)

    def _quarantine(self, digest: str, path: str, why: str) -> None:
        """A corrupt content-addressed object: move it aside (forensics,
        and so the next write-once publish can heal the handle) and
        surface the store's missing-handle contract — callers already
        treat KeyError as 'fetch it another way', which is exactly what a
        torn record must degrade to.  Never serve, never crash."""
        os.makedirs(self._quarantine_dir, exist_ok=True)
        dest = os.path.join(self._quarantine_dir, digest)
        try:
            os.replace(path, dest)
        except OSError:
            pass  # best-effort: losing the evidence must not mask the miss
        raise KeyError(
            f"summary object {digest} was corrupt ({why}); quarantined")

    def _load_from_disk(self, digest: str) -> Union[SummaryTree, SummaryBlob]:
        path = os.path.join(self._objects_dir, digest)
        if not os.path.exists(path):
            raise KeyError(digest)
        with open(path, "rb") as f:
            raw = f.read()
        try:
            obj = json.loads(raw)
            if obj["kind"] == "blob":
                node: Union[SummaryTree, SummaryBlob] = SummaryBlob(
                    base64.b64decode(obj["content"]))
                children = {}
            else:
                node = SummaryTree()
                children = dict(obj["children"])
        except (ValueError, KeyError, TypeError) as exc:
            self._quarantine(digest, path, f"undecodable: {exc!r}")
        for name, child_digest in children.items():
            # A missing/quarantined CHILD propagates its own KeyError —
            # this (structurally valid) parent is not the corrupt record.
            node.children[name] = self.read(child_digest)
        # Checksum gate: content-addressing means the handle IS the
        # checksum — a decodable-but-wrong object (bit rot, torn write
        # that still parses) must not be served under a digest it does
        # not hash to.
        if node.digest() != digest:
            self._quarantine(digest, path, "digest mismatch")
        return node


class FileDocumentServiceFactory(LocalDocumentServiceFactory):
    """The whole service stack rooted in one directory; reopen to resume."""

    def __init__(self, root: str, faults=None) -> None:
        os.makedirs(root, exist_ok=True)
        self.root = root
        service = LocalOrderingService(
            oplog=OpLog(os.path.join(root, "ops.jsonl"), faults=faults),
            storage=FileSummaryStorage(root, faults=faults),
        )
        super().__init__(service)

    def close(self) -> None:
        # Idempotent end to end: OpLog.close() no-ops once its file handle
        # is None'd, so a factory closed from both a host teardown and a
        # with-block/atexit sweep flushes and closes exactly once
        # (fluidleak FL-LEAK-DOUBLE-CLOSE discipline; pinned by
        # tests/test_lifecycle.py).
        self.service.oplog.close()
