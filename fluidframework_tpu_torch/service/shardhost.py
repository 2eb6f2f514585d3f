"""fluidproc shard host: ONE orderer shard as a standalone server process.

The out-of-process half of the sharded ordering tier.  The in-proc
``ShardedOrderingService`` partitioned documents across N orderer shards
but kept them in one process over ONE shared durable log — the last
single point of serialization.  A shard host is that shard taken out of
process, the way the reference scales Deli/Scriptorium as separate
services (PAPER.md §2.3):

- one :class:`~.orderer.LocalOrderingService` holding this shard's
  documents,
- its **own durable op log** file (``shard_log_path(base_dir, shard_id)``
  — per-shard logs are what make N shards N independent fsync streams),
- the **shared content-addressed summary store** on disk
  (``<base_dir>/summaries`` — content addressing makes cross-process
  sharing safe: objects publish by atomic rename, per-doc ref chains are
  only ever written by the doc's single owner),
- the existing :class:`~.server.OrderingServer` frame protocol over TCP,
  extended with the shard control plane the front door drives:

  ====================  =====================================================
  ``shard_info``        identity: shard id, pid, epoch, base dir
  ``stats``             per-shard counters (docs, ops, heads, retired)
  ``heads``             bulk ``{doc: durable head}`` read
  ``log_contiguous``    per-doc seq-contiguity check on the durable log
  ``submit_mixed``      batched ingress: boxed + columnar shapes, one
                        group commit (the swarm path over the wire)
  ``connect_many``      bulk JOIN cohort for one document
  ``bump_epoch``        adopt the fence epoch the front door derived
  ``freeze_doc``        migration step 1: fence the orderer, seal its
                        bytes, return the checkpoint at the frozen head
  ``export_doc``        migration step 2: the doc's full log span
  ``import_doc``        migration step 3 (target side): append the span
                        into OWN log, restore the orderer from the
                        frozen checkpoint (quorum + dedup floors continue)
  ``thaw_doc``          migration abort: drop the fenced orderer; the
                        next touch lazily recovers a live one from log
  ``retire_doc``        migration step 5 (source side): never serve the
                        doc again — answer ``wrongShard`` (redirect)
  ``adopt_doc``         failover: import the doc's span from a DEAD
                        peer's log file and recover the orderer
  ====================  =====================================================

Lifecycle: SIGTERM triggers **drain-and-seal** — in-flight work finishes
(a group commit in progress is never torn; the signal callback runs on
the same event loop the inline ingress does), new work is refused with a
typed retryable ``shuttingDown`` nack, and the per-shard log is flushed,
fsynced, and closed.  A restart over the same directory replays the
sealed log and resumes the sequence contiguously (the regression tests
pin no-duplicate-lines + contiguous seqs across restart).

The port's copy of ``fluidframework_tpu/service/shardhost.py``: each
shard process folds its catch-ups on its own ``device`` (``--device``,
the card by default, checked before anything is created), through the
server's lazy ``CatchupService``.  Several shard processes on one card
each open their own CUDA context; none builds a kernel the parent has
not built (``ops/_cuda_build.py`` renames a finished build into place).

Run standalone (what the front door spawns):

    python -m fluidframework_tpu_torch.service.shardhost \
        --shard-id shard00 --dir /path/to/deployment --port 0 \
        [--device cuda|cpu]
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..ops.mergetree_kernel import resolve_device
from ..protocol import errors as wire_errors
from ..protocol.messages import DocRelocatedError, ShardFencedError
from ..protocol.wire import (decode_column_batch, decode_raw_operation,
                             decode_sequenced_message,
                             encode_sequenced_message)
from .oplog import OpLog, shard_log_path
from .orderer import DocumentOrderer, LocalOrderingService, SubmitOutcome
from .server import OrderingServer

#: doc-scoped methods a RETIRED document still answers on this host
#: (nothing — even reads must route to the live owner, whose log holds
#: the spans stamped after the migration).
_RETIRE_EXEMPT = frozenset({"ping", "stats", "shard_info", "adopt_doc",
                            "import_doc"})


def _outcome_wire(outcome: SubmitOutcome) -> dict:
    """One per-doc submit outcome as a wire dict (errors by code + text;
    exception objects do not cross processes).  The classification IS
    the outcome channel of the protocol/errors.py registry — every code
    emitted here must be a registered row (FL-ERR-CODE pins the literals
    statically; the assert pins the runtime)."""
    error = outcome.error
    if error is None:
        code = None
    elif isinstance(error, ShardFencedError):
        code = "fenced"
    elif isinstance(error, KeyError):
        code = "unknownDoc"
    else:
        code = "fault"
    assert code is None or wire_errors.is_registered(code)
    return {
        "stamped": outcome.n_stamped(),
        "consumed": outcome.consumed,
        "error": str(error) if error is not None else None,
        "code": code,
    }


class ShardHost:
    """One shard's service state plus the control-plane verbs.

    All handlers run INLINE on the server's event loop (single-threaded
    by construction — the per-shard log has exactly one writer thread,
    and a SIGTERM can never land mid-handler), except the catch-up/
    summary-upload routes the base server already offloads.
    """

    def __init__(self, shard_id: str, base_dir: str, faults=None) -> None:
        from ..drivers.file_driver import FileSummaryStorage

        self.shard_id = shard_id
        self.base_dir = base_dir
        log_path = shard_log_path(base_dir, shard_id)
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        self.oplog = OpLog(path=log_path, autoflush=True, faults=faults)
        self.storage = FileSummaryStorage(
            os.path.join(base_dir, "summaries"), faults=faults)
        self.service = LocalOrderingService(oplog=self.oplog,
                                            storage=self.storage)
        #: documents migrated AWAY: this host must never serve them again
        #: (its log keeps their pre-migration span, but the live span is
        #: elsewhere — serving would fork the sequence).
        self._retired: set = set()
        #: read-only views of dead peers' log files, one per peer (the
        #: file is static once its owner is dead, so the parse is paid
        #: once per peer, not once per adopted document).
        self._peer_logs: Dict[str, OpLog] = {}
        self._sealed = False

    # -- identity / introspection ----------------------------------------------

    def is_retired(self, doc_id: str) -> bool:
        return doc_id in self._retired

    def shard_info(self) -> dict:
        return {
            "shard": self.shard_id,
            "pid": os.getpid(),
            "epoch": self.storage.epoch,
            "dir": self.base_dir,
        }

    def stats(self) -> dict:
        docs = self.oplog.doc_ids()
        heads = {d: self.oplog.head(d) for d in docs}
        return {
            "shard": self.shard_id,
            "pid": os.getpid(),
            "docs": len(docs),
            "ops": sum(heads.values()),
            "heads": heads,
            "retired": sorted(self._retired),
            "epoch": self.storage.epoch,
        }

    def heads(self, doc_ids: List[str]) -> Dict[str, int]:
        return {d: self.oplog.head(d) for d in doc_ids}

    def log_contiguous(self, doc_id: str) -> bool:
        return self.oplog.is_contiguous(doc_id)

    def contiguous(self, doc_ids: List[str]) -> Dict[str, bool]:
        """Bulk contiguity check — one RPC for a whole doc set (the
        swarm's end-of-run verification is O(docs))."""
        return {d: self.oplog.is_contiguous(d) for d in doc_ids}

    # -- batched ingress over the wire -----------------------------------------

    def submit_mixed_wire(self, params: dict) -> Dict[str, dict]:
        """The swarm's batched-ingress RPC: boxed op lists and/or a
        columnar batch slice, stamped through the real
        ``service.submit_mixed`` under ONE group commit of this shard's
        own log."""
        batches = {
            doc: [decode_raw_operation(d) for d in ops]
            for doc, ops in (params.get("batches") or {}).items()
        } or None
        batch = None
        doc_rows = None
        if params.get("columns") is not None:
            batch = decode_column_batch(params["columns"])
            doc_rows = {
                doc: np.arange(int(s), int(e), dtype=np.int64)
                for doc, (s, e) in (params.get("doc_rows") or {}).items()
            }
        outcomes = self.service.submit_mixed(batches, batch, doc_rows)
        return {doc: _outcome_wire(o) for doc, o in outcomes.items()}

    def connect_many_wire(self, params: dict) -> bool:
        endpoint = self.service.endpoint(params["doc"])
        clients = list(params["clients"])
        with self.oplog.batch():  # one fsync per JOIN cohort
            if params.get("columnar", True):
                endpoint.connect_columns(clients, params.get("session"))
            else:
                endpoint.connect_many(clients, params.get("session"))
        return True

    # -- fence epoch -----------------------------------------------------------

    def bump_epoch(self, token: str) -> str:
        """Adopt the deterministic fence epoch the front door derived for
        a failover: every surviving shard lands on the same generation,
        and the shared epoch file persists it for late spawns."""
        return self.storage.bump_epoch(token)

    # -- migration (freeze → export → import → retire / thaw) ------------------

    def _orderer_of(self, doc_id: str) -> DocumentOrderer:
        self.service.endpoint(doc_id)  # ensure recovered (single-flight)
        with self.service.state_lock:
            return self.service._orderers[doc_id]

    def freeze_doc(self, doc_id: str) -> dict:
        """Migration step 1 (source): fence the document's orderer —
        every in-flight stamp lands or aborts before the fence returns
        (the durable-append gate shares the fence lock) — then seal its
        bytes and checkpoint at the frozen head.  The checkpoint is the
        quorum/dedup continuation the target restores, so the migrated
        orderer stamps the exact bytes the source would have."""
        orderer = self._orderer_of(doc_id)
        orderer.fence()
        self.oplog.flush()
        return {
            "head": self.oplog.head(doc_id),
            "checkpoint": orderer.checkpoint(),
        }

    def export_doc(self, doc_id: str) -> dict:
        """Migration step 2 (source): the document's full durable span,
        codec-encoded — plus the latest summary commit handle (the
        summary OBJECTS never move: the store is shared and
        content-addressed).  A TRUNCATED document exports its live
        suffix (the sealed prefix is gone by construction) plus the
        floor and the marker's recovery checkpoint, so the importer
        reconstructs the same guarded view."""
        floor = self.oplog.floor(doc_id)
        return {
            "records": [encode_sequenced_message(m)
                        for m in self.oplog.get(doc_id, from_seq=floor)],
            "head": self.oplog.head(doc_id),
            "summary": self.storage.head(doc_id),
            "floor": floor,
            "trunc_checkpoint": self.oplog.truncation_checkpoint(doc_id),
        }

    def import_doc(self, doc_id: str, records: List[dict],
                   checkpoint: Optional[dict] = None,
                   floor: int = 0,
                   trunc_checkpoint: Optional[dict] = None) -> dict:
        """Migration step 3 (target): append the span into THIS shard's
        log (idempotent — seq-deduped, so a retried import after a crash
        mid-transfer lands exactly once), fsync it, then install the
        orderer restored from the frozen checkpoint.  Without a
        checkpoint (failover adoption), the orderer recovers by full log
        replay instead.  ``floor``/``trunc_checkpoint`` carry a
        truncated source's sealed boundary: the marker is adopted into
        this log so reads below the floor keep failing loudly and a
        later recovery still has its checkpoint."""
        self._retired.discard(doc_id)
        # The previous owner appended this doc's summary-commit chain to
        # the shared store from ITS process; merge those records into
        # this instance's chain view before anything reads or extends it
        # (a stale head would fork the chain on the next upload).
        self.storage.refresh_doc(doc_id)
        with self.oplog.batch():
            for rec in records:
                self.oplog.append(doc_id, decode_sequenced_message(rec))
        self.oplog.flush()  # commit-point: imported span fsync
        if floor > 0:
            self.oplog.adopt_floor(doc_id, int(floor), trunc_checkpoint)
        if checkpoint is not None:
            self.service.adopt_orderer(
                doc_id,
                DocumentOrderer.restore(doc_id, self.oplog, self.storage,
                                        checkpoint))
        elif self.oplog.head(doc_id) > 0:
            self.service.endpoint(doc_id)  # eager recovery from own log
        elif self.storage.head(doc_id) is not None:
            try:
                self.service.create_document(doc_id)  # summary-only doc
            except ValueError:
                pass  # lost a benign create race with a concurrent touch
        else:
            raise KeyError(f"document {doc_id!r} has no records, no "
                           "checkpoint and no summary to adopt")
        return {"head": self.oplog.head(doc_id)}

    def thaw_doc(self, doc_id: str) -> bool:
        """Migration ABORT (target died before the flip): drop the
        frozen orderer so the next touch lazily recovers a LIVE one from
        this shard's own log — the document never left."""
        self.service.drop_orderer(doc_id)
        return True

    def retire_doc(self, doc_id: str) -> bool:
        """Migration step 5 (source, post-flip): never serve this
        document again.  Requests answer ``wrongShard`` (the redirect
        code) — the stale pre-migration span in this log must not be
        replayable into a second live sequence."""
        self._retired.add(doc_id)
        self.service.drop_orderer(doc_id)
        return True

    def adopt_doc(self, doc_id: str, from_shard: str) -> dict:
        """Failover: import the document's span from a DEAD peer's log
        file (read-only view; the front door SIGKILLs the peer before
        re-owning, so the file has exactly zero writers) and recover the
        orderer by replay.  Idempotent — re-adoption dedups.

        A document with NOTHING durable anywhere (created but never
        joined/summarized before its shard died) answers a structured
        ``{"nothing": true}`` verdict — the in-proc-parity "the document
        no longer exists" outcome — distinct from any real import
        failure (corrupt object, replay error), which RAISES and must
        keep the caller's orphan mark so the history is never silently
        abandoned."""
        peer = self._peer_logs.get(from_shard)
        if peer is None:
            path = shard_log_path(self.base_dir, from_shard)
            if os.path.exists(path):
                peer = OpLog(path=path, read_only=True)
            else:
                peer = OpLog()  # peer never wrote: empty view
            self._peer_logs[from_shard] = peer
        peer_floor = peer.floor(doc_id)
        records = [encode_sequenced_message(m)
                   for m in peer.get(doc_id, from_seq=peer_floor)]
        if not records and peer_floor == 0:
            self.storage.refresh_doc(doc_id)
            if self.storage.head(doc_id) is None \
                    and self.oplog.head(doc_id) == 0:
                return {"head": 0, "nothing": True}
        return self.import_doc(
            doc_id, records, checkpoint=None, floor=peer_floor,
            trunc_checkpoint=peer.truncation_checkpoint(doc_id))

    # -- lifecycle -------------------------------------------------------------

    def seal(self) -> None:
        """Flush, fsync, and close the per-shard log (the drain
        sequence's final step).  Idempotent."""
        if self._sealed:
            return
        self._sealed = True
        self.oplog.close()


class ShardHostServer(OrderingServer):
    """The shard host's TCP surface: the full OrderingServer protocol
    plus the control-plane verbs, with retired documents answering the
    ``wrongShard`` redirect on every doc-scoped route."""

    def __init__(self, host: ShardHost, tcp_host: str = "127.0.0.1",
                 port: int = 0, faults=None, device="cuda") -> None:
        super().__init__(host.service, host=tcp_host, port=port,
                         faults=faults, device=device)
        self.shard = host
        self.extra_methods.update({
            "shard_info": lambda s, p: host.shard_info(),
            "stats": lambda s, p: self._shard_stats(),
            "heads": lambda s, p: host.heads(list(p.get("docs") or ())),
            "log_contiguous": lambda s, p: (
                host.contiguous(list(p["docs"])) if "docs" in p
                else host.log_contiguous(p["doc"])),
            "submit_mixed": lambda s, p: self._submit_mixed(p),
            "connect_many": lambda s, p: host.connect_many_wire(p),
            "bump_epoch": lambda s, p: host.bump_epoch(p["token"]),
            "freeze_doc": lambda s, p: host.freeze_doc(p["doc"]),
            "export_doc": lambda s, p: host.export_doc(p["doc"]),
            "import_doc": lambda s, p: host.import_doc(
                p["doc"], p.get("records") or [], p.get("checkpoint"),
                floor=int(p.get("floor") or 0),
                trunc_checkpoint=p.get("trunc_checkpoint")),
            "thaw_doc": lambda s, p: host.thaw_doc(p["doc"]),
            "retire_doc": lambda s, p: host.retire_doc(p["doc"]),
            "adopt_doc": lambda s, p: host.adopt_doc(
                p["doc"], p["from_shard"]),
        })
        self.drain_exempt = {"ping", "stats", "shard_info"}

    def _submit_mixed(self, params: dict) -> Dict[str, dict]:
        """Batched ingress + streaming cadence: the group commit lands
        first (batch closed, bytes durable), THEN a due streaming round
        folds — never inside the commit's ``oplog.batch()``, the
        truncation marker needs a real flush for its commit point."""
        out = self.shard.submit_mixed_wire(params)
        if self.stream_enabled:
            streamfold = self._ensure_streamfold()
            if streamfold is not None:
                streamfold.poll()
        return out

    def _shard_stats(self) -> dict:
        from ..ops.launches import launch_counts

        out = self.shard.stats()
        #: this process's kernel launches (its folds run here, so no
        #: other process's counters see them)
        out["launches"] = launch_counts()
        out["admission"] = self.admission.snapshot()
        out["stream"] = (self.streamfold.stats()
                         if self.streamfold is not None else None)
        out["truncations"] = self.shard.oplog.truncations
        out["truncated_msgs"] = self.shard.oplog.truncated_msgs
        out["log_bytes_reclaimed"] = self.shard.oplog.bytes_reclaimed
        return out

    def _dispatch(self, session, method: str, params: dict):
        doc = params.get("doc")
        if doc is not None and method not in _RETIRE_EXEMPT \
                and self.shard.is_retired(doc):
            raise DocRelocatedError(doc)
        return super()._dispatch(session, method, params)


def apply_shard_flags(server, argv) -> None:
    """Apply the tuning subset of the shardhost CLI to a LIVE server.

    Shared by ``main()`` (real processes) and ``ThreadShard`` (in-thread
    shards): both spawn modes take the same ``--shard-arg`` vocabulary,
    and a failover RESPAWN re-applies it automatically — a restarted
    storm shard comes back with the same wire-clock admission shape as
    the one that died.  Deployment knobs, not config gates: post-ctor
    attributes exactly like the in-proc harnesses set them (the gate
    registry stays the single source of DEFAULTS; these override
    per-process)."""
    argv = list(argv)
    i = 0
    while i < len(argv):
        flag = argv[i]
        if flag == "--virtual-admission":
            server.admission_control.virtual = True
            i += 1
            continue
        if i + 1 >= len(argv):
            raise ValueError(f"shard flag {flag!r} needs a value")
        value = argv[i + 1]
        if flag == "--catchup-hold":
            server.catchup_hold_seconds = float(value)
        elif flag == "--catchup-max-inflight":
            server.admission_control.max_inflight = max(1, int(value))
        elif flag == "--catchup-degrade-after":
            server.admission_control.degrade_after = max(0, int(value))
        else:
            raise ValueError(f"unknown shard flag {flag!r}")
        i += 2


def main(argv=None) -> None:
    import argparse
    import asyncio
    import signal

    parser = argparse.ArgumentParser(
        description="fluidproc shard host (one orderer shard, own "
                    "durable log, shared summary store)")
    parser.add_argument("--shard-id", required=True)
    parser.add_argument("--dir", required=True,
                        help="shared deployment directory (per-shard logs "
                             "under shards/<id>/, summaries under "
                             "summaries/)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--fault-plan", default=None,
                        help="optional faultline plan JSON arming this "
                             "host's oplog/storage seams (chaos runs)")
    parser.add_argument("--stream", action="store_true",
                        help="attach the streaming fold: fold "
                             "committed micro-batches continuously and "
                             "truncate the per-shard log below durable "
                             "summaries")
    parser.add_argument("--stream-cadence", type=int, default=None,
                        help="fold once a doc has this many unfolded ops")
    parser.add_argument("--stream-retention", type=int, default=None,
                        help="never truncate the newest N ops")
    parser.add_argument("--virtual-admission", action="store_true",
                        help="wire-clock catchup admission: "
                             "the controller's clock advances only on "
                             "vnow values carried by catchup requests — "
                             "deterministic out-of-proc storm verdicts")
    parser.add_argument("--catchup-hold", type=float, default=None,
                        help="modeled fold duration: extra clock seconds "
                             "an admission lease occupies its slot after "
                             "release (storm harness load model)")
    parser.add_argument("--catchup-max-inflight", type=int, default=None,
                        help="override the catchup fold lane's admission "
                             "slot count")
    parser.add_argument("--catchup-degrade-after", type=int, default=None,
                        help="consecutive sheds before the verdict "
                             "degrades to stored-summary serving")
    parser.add_argument(
        "--device", default="cuda",
        help="the device of this shard's catch-up fold (default 'cuda'; "
             "'cpu' runs the plain folds on the host).  Checked at start: "
             "without a CUDA device the default refuses to start")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        parser.error(str(exc))

    faults = None
    if args.fault_plan:
        import json

        from ..testing.faults import FaultInjector, FaultPlan, FaultPoint

        with open(args.fault_plan, "r", encoding="utf-8") as f:
            doc = json.load(f)
        faults = FaultInjector(FaultPlan(
            seed=doc.get("seed", 0),
            points=tuple(
                FaultPoint(site=p["site"], kind=p["kind"],
                           at=int(p.get("at", 1)),
                           count=int(p.get("count", 1)),
                           doc=p.get("doc"), shard=p.get("shard"),
                           arg=float(p.get("arg", 0.0)))
                for p in doc.get("points", ())
            )))

    host = ShardHost(args.shard_id, args.dir, faults=faults)
    # The injector arms the server-side seams too (catchup.fail /
    # catchup.slow / session.write), not just the durable tier's.
    server = ShardHostServer(host, tcp_host=args.host, port=args.port,
                             faults=faults, device=device)
    if args.stream:
        server.enable_streaming(cadence_ops=args.stream_cadence,
                                retention_floor=args.stream_retention)
    # One application point for both spawn modes: re-encode the parsed
    # tuning flags and run them through the same helper ThreadShard uses.
    flags: list = []
    if args.virtual_admission:
        flags.append("--virtual-admission")
    if args.catchup_hold is not None:
        flags += ["--catchup-hold", str(args.catchup_hold)]
    if args.catchup_max_inflight is not None:
        flags += ["--catchup-max-inflight", str(args.catchup_max_inflight)]
    if args.catchup_degrade_after is not None:
        flags += ["--catchup-degrade-after", str(args.catchup_degrade_after)]
    apply_shard_flags(server, flags)
    if device.type == "cuda":
        # Open this process's CUDA context before it reports listening:
        # the first catch-up does not pay for it.
        import torch

        torch.zeros(1, device=device)

    async def _run():
        await server.start()
        print(f"shardhost {host.shard_id} listening on "
              f"{server.host}:{server.port} pid={os.getpid()}", flush=True)
        loop = asyncio.get_running_loop()
        stop = loop.create_future()

        def _on_term():
            if not stop.done():
                stop.set_result(None)

        loop.add_signal_handler(signal.SIGTERM, _on_term)
        await stop
        # Drain-and-seal: the signal callback above ran BETWEEN loop
        # callbacks, so no inline dispatch (no group commit) is mid
        # flight; refuse new work, wait out offloaded folds, seal the
        # per-shard log so a restart resumes contiguous.
        await server.drain_and_seal(seal=host.seal)
        print(f"shardhost {host.shard_id} sealed", flush=True)

    asyncio.run(_run())


if __name__ == "__main__":
    main()
