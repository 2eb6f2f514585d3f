"""Replay tool — rebuild any historical document state from a file store.

Capability-equivalent of the reference's ``replay-tool`` / ``fluid-runner``
(SURVEY.md §2.4: replay an op log offline against snapshots — debugging,
perf work, state forensics).

Usage:
    python -m fluidframework_tpu_torch.tools.replay <store-dir> <doc-id> \
        [--to-seq N] [--json] [--show ds/channel] [--history]

Reads the durable file store (FileDocumentServiceFactory layout), loads the
document as of ``--to-seq`` (default: head) through the replay driver, and
prints a state report: sequence point, summary digest, datastores/channels,
and optionally one channel's content."""

from __future__ import annotations

import argparse
import json
import sys

from ..drivers.file_driver import FileSummaryStorage
from ..drivers.replay_driver import ReplayDocumentService
from ..loader import Loader
from ..service.oplog import OpLog


class _ReplayFactory:
    def __init__(self, oplog, storage, to_seq):
        self.oplog, self.storage, self.to_seq = oplog, storage, to_seq

    def resolve(self, doc_id):
        return ReplayDocumentService(doc_id, self.oplog, self.storage,
                                     to_seq=self.to_seq)


def replay(store_dir: str, doc_id: str, to_seq=None) -> dict:
    """Programmatic entry: returns the state report dict."""
    import os

    oplog = OpLog(os.path.join(store_dir, "ops.jsonl"))
    storage = FileSummaryStorage(store_dir)
    loader = Loader(_ReplayFactory(oplog, storage, to_seq))
    container = loader.resolve(doc_id)
    runtime = container.runtime
    summary = runtime.summarize()
    report = {
        "docId": doc_id,
        "seq": runtime.ref_seq,
        "minSeq": runtime.min_seq,
        "summaryDigest": summary.digest(),
        "quorum": runtime.election.quorum,
        "catchupOps": container.catchup_ops,
        "datastores": {
            ds_id: {ch_id: ch.TYPE for ch_id, ch in ds.channels.items()}
            for ds_id, ds in sorted(runtime.datastores.items())
        },
    }
    report["_runtime"] = runtime  # for --show / programmatic callers
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("store_dir")
    parser.add_argument("doc_id")
    parser.add_argument("--to-seq", type=int, default=None)
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    parser.add_argument("--show", default=None, metavar="DS/CHANNEL",
                        help="print one channel's content")
    parser.add_argument("--history", action="store_true",
                        help="print the document's summary commit chain")
    args = parser.parse_args(argv)

    if args.history:
        if args.show:
            parser.error("--show does not combine with --history")
        storage = FileSummaryStorage(args.store_dir)
        commits = storage.history(args.doc_id)
        if args.to_seq is not None:
            commits = [c for c in commits if c.ref_seq <= args.to_seq]
        if args.json:
            print(json.dumps([
                {"commit": c.digest(), "tree": c.tree, "parent": c.parent,
                 "refSeq": c.ref_seq, "message": c.message}
                for c in commits
            ], sort_keys=True))
        else:
            for c in commits:
                print(f"{c.digest()[:12]}  tree {c.tree[:12]}  "
                      f"@seq {c.ref_seq}  {c.message}")
        return 0

    report = replay(args.store_dir, args.doc_id, args.to_seq)
    runtime = report.pop("_runtime")
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(f"doc {report['docId']} @ seq {report['seq']} "
              f"(minSeq {report['minSeq']})")
        print(f"summary {report['summaryDigest']}")
        print(f"quorum  {report['quorum']}")
        for ds_id, channels in report["datastores"].items():
            for ch_id, type_name in channels.items():
                print(f"  {ds_id}/{ch_id}  [{type_name}]")
    if args.show:
        ds_id, channel_id = args.show.split("/", 1)
        channel = runtime.get_datastore(ds_id).get_channel(channel_id)
        text = getattr(channel, "text", None)
        if text is not None:
            print(text)
        else:
            print(channel.summarize().blob_bytes("header").decode("utf-8"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
