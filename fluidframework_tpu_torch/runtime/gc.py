"""Garbage collection: mark-and-sweep over the handle graph.

Capability-equivalent of the reference's ``GarbageCollector``
(container-runtime ``gc/``; SURVEY.md §2.1; upstream paths UNVERIFIED —
empty reference mount), adapted to this runtime's summary model:

- **Mark**: reachability over datastores, walked from the *root set*
  (datastores flagged rooted at creation) through
  ``{"fluidHandle": "/ds[/channel]"}`` tokens found in channel summary
  bytes.  Scanning serialized summaries makes marking format-agnostic.
- **Unreferenced tracking** (run at summarize time, mutating only GC
  bookkeeping — never live runtime state): a datastore/blob that falls out
  of the reachable set is stamped ``unreferencedAtSeq``; reachability
  again clears the stamp (inactive→revived).  Stamps ride the summary.
- **Sweep** is a *sequenced runtime op*: when a stamp has outlived
  ``sweep_grace_ops``, ``ContainerRuntime.perform_gc_sweep()`` submits
  ``{"runtime": "gcSweep", "ids": [...]}``; every replica deletes the
  datastores at the same fold position — summarizing never mutates
  replica state, and a nacked summary can't orphan the summarizer.
- **Attachment blobs** get the same grace: an unreferenced blob's bytes
  stay in summaries until its stamp expires, so a reference written in
  the post-summary op tail still resolves (zero-grace
  dropped bytes a later-sequenced handle needed).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

from ..protocol.summary import SummaryTree
from .handles import scan_blob_refs, scan_handles


@dataclasses.dataclass
class GCOptions:
    enabled: bool = True
    #: sequenced ops an unreferenced datastore/blob survives before sweep
    sweep_grace_ops: int = 200


class GarbageCollector:
    """Mark + stamp + sweep bookkeeping; one per container runtime."""

    def __init__(self, runtime, options: Optional[GCOptions] = None) -> None:
        self.runtime = runtime
        self.options = options or GCOptions()
        # ds_id -> seq at which it became unreferenced
        self.unreferenced_at: Dict[str, int] = {}
        # blob sha -> seq at which it became unreferenced
        self.blob_unreferenced_at: Dict[str, int] = {}
        self.swept: List[str] = []

    # -- the mark phase --------------------------------------------------------

    def _reachable(self, ds_summaries: Dict[str, SummaryTree]) -> Set[str]:
        """Datastores reachable from the root set via handle tokens."""
        roots = {ds_id for ds_id, ds in self.runtime.datastores.items()
                 if getattr(ds, "rooted", True)}
        edges: Dict[str, Set[str]] = {}
        for ds_id, tree in ds_summaries.items():
            refs: Set[str] = set()
            for blob in _walk_blobs(tree):
                for path in scan_handles(blob):
                    refs.add(path.lstrip("/").split("/")[0])
            edges[ds_id] = refs
        seen: Set[str] = set()
        frontier = [r for r in roots if r in ds_summaries]
        while frontier:
            ds_id = frontier.pop()
            if ds_id in seen:
                continue
            seen.add(ds_id)
            frontier.extend(t for t in edges.get(ds_id, ())
                            if t in ds_summaries and t not in seen)
        return seen

    def referenced_blob_shas(
        self, ds_summaries: Dict[str, SummaryTree]
    ) -> Set[str]:
        shas: Set[str] = set()
        for tree in ds_summaries.values():
            shas |= scan_blob_refs(_walk_concat(tree))
        return shas

    # -- stamp update at summarize time (GC bookkeeping only) ------------------

    def run(self, ds_summaries: Dict[str, SummaryTree],
            current_seq: int) -> dict:
        """Refresh unreferenced stamps; returns the serializable gc state.
        Never touches live runtime state — sweeping is a sequenced op."""
        if self.options.enabled:
            reachable = self._reachable(ds_summaries)
            for ds_id in ds_summaries:
                if ds_id in reachable:
                    self.unreferenced_at.pop(ds_id, None)
                else:
                    self.unreferenced_at.setdefault(ds_id, current_seq)
            referenced = self.referenced_blob_shas(ds_summaries)
            for sha in self.runtime.blob_manager.shas():
                if sha in referenced:
                    self.blob_unreferenced_at.pop(sha, None)
                else:
                    self.blob_unreferenced_at.setdefault(sha, current_seq)
        return {
            "swept": sorted(self.swept),
            "unreferenced": {k: self.unreferenced_at[k]
                             for k in sorted(self.unreferenced_at)},
            "unreferencedBlobs": {
                k: self.blob_unreferenced_at[k]
                for k in sorted(self.blob_unreferenced_at)
            },
        }

    @staticmethod
    def empty_state() -> dict:
        return {"swept": [], "unreferenced": {}, "unreferencedBlobs": {}}

    # -- sweep readiness / execution -------------------------------------------

    def sweep_ready(self, current_seq: int) -> List[str]:
        grace = self.options.sweep_grace_ops
        return sorted(ds_id for ds_id, since in self.unreferenced_at.items()
                      if current_seq - since >= grace)

    def apply_sweep(self, ds_ids: List[str]) -> None:
        """The sequenced gcSweep op: identical fold position everywhere."""
        for ds_id in ds_ids:
            self.runtime.datastores.pop(ds_id, None)
            self.unreferenced_at.pop(ds_id, None)
            if ds_id not in self.swept:
                self.swept.append(ds_id)

    def surviving_blob_shas(self, current_seq: int) -> Set[str]:
        """Blobs that belong in the summary: referenced, or unreferenced
        but still inside the grace window."""
        grace = self.options.sweep_grace_ops
        return {
            sha for sha in self.runtime.blob_manager.shas()
            if current_seq - self.blob_unreferenced_at.get(sha, current_seq)
            < grace
        }

    # -- persistence -----------------------------------------------------------

    def load_state(self, state: dict) -> None:
        self.unreferenced_at = dict(state.get("unreferenced", {}))
        self.blob_unreferenced_at = dict(state.get("unreferencedBlobs", {}))
        self.swept = list(state.get("swept", []))


def _walk_blobs(tree: SummaryTree):
    for child in tree.children.values():
        if isinstance(child, SummaryTree):
            yield from _walk_blobs(child)
        else:
            yield child.content


def _walk_concat(tree: SummaryTree) -> bytes:
    return b"\x00".join(_walk_blobs(tree))
