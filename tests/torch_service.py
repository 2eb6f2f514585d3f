"""Shared harness for the port's catch-up service tests
(tests/test_torch_catchup.py, test_torch_attribution.py).

A ``ServicePair`` holds the JAX package's ``CatchupService(mesh=None)``
over a JAX-package ``LocalOrderingService`` and the port's
``CatchupService(device="cpu")`` over a port service whose summary store
and op log were carried across as plain data (``export_corpus`` here,
``convert.load_service_corpus`` in the port).  Each ``catch_up`` first
appends the reference log's new messages to the port's, runs both
services, and asserts equal results (``{doc: (handle, seq)}``), equal
per-call ``stats`` deltas, equal route counters, equal
``pipeline_stats``, the same ``pipeline_stage`` keys with equal byte
counters, and an equal ``stats()`` dict for every cache tier.
"""

from fluidframework_tpu.service import LocalOrderingService as RefOrdering
from fluidframework_tpu.service.catchup import CatchupService as RefCatchup
from fluidframework_tpu_torch.convert import load_service_corpus
from fluidframework_tpu_torch.service import LocalOrderingService
from fluidframework_tpu_torch.service.catchup import CatchupService
from tests.torch_corpora import port_stage_keys

TIERS = ("cache", "_pack_cache", "delta_cache", "device_cache",
         "tree_pack_cache", "tree_device_cache")
COUNTERS = ("device_docs", "cpu_docs", "host_channels", "fallback_channels")


def plain_summary(tree):
    """A summary tree as nested plain data: ``{name: bytes | dict}``."""
    return {name: plain_summary(child) if hasattr(child, "children")
            else child.content for name, child in tree.children.items()}


def export_corpus(service, doc_ids=None, summaries=True):
    """A service's store and log as ``load_service_corpus`` takes them:
    each document's latest summary (when ``summaries`` and it has one)
    and every message of its log as a field dict."""
    out = {}
    for doc_id in doc_ids if doc_ids is not None else service.doc_ids():
        entry = {"messages": [m.to_dict() for m in service.oplog.get(doc_id)]}
        tree, seq = service.storage.latest(doc_id)
        if summaries and tree is not None:
            entry.update(summary=plain_summary(tree), seq=seq)
        out[doc_id] = entry
    return out


def reference_service(port_service, into=None):
    """A JAX-package ``LocalOrderingService`` holding a port service's
    store and log (for corpora only the port's builders make); with
    ``into``, the port log's new messages are appended to that service
    instead (its log drops what it already holds)."""
    from fluidframework_tpu.protocol.messages import SequencedMessage
    from fluidframework_tpu.protocol.summary import SummaryBlob, SummaryTree

    def tree_of(obj):
        out = SummaryTree()
        for name, child in obj.items():
            out.children[name] = tree_of(child) if isinstance(child, dict) \
                else SummaryBlob(child)
        return out

    ref = into if into is not None else RefOrdering()
    for doc_id, doc in export_corpus(port_service,
                                     summaries=into is None).items():
        if "summary" in doc:
            ref.storage.upload(doc_id, tree_of(doc["summary"]), doc["seq"])
        for m in doc["messages"]:
            ref.oplog.append(doc_id, SequencedMessage.from_dict(m))
    return ref


def force_cpu(svc):
    """Route every document to the container fold (as the reference's
    tests do): the device plan always fails."""
    svc._device_plan = lambda work: None
    return svc


class ServicePair:
    """Matching catch-up services over one corpus: the reference on its
    service, the port on a copy of it.  ``cpu=True`` forces both onto
    the container fold; other keywords go to both constructors."""

    def __init__(self, ref_service, cpu=False, **kw):
        self.ref_service = ref_service
        self.port_service = LocalOrderingService()
        self.ref = RefCatchup(ref_service, mesh=None, **kw)
        self.port = CatchupService(self.port_service, device="cpu", **kw)
        if cpu:
            force_cpu(self.ref)
            force_cpu(self.port)
        self.sync()

    def sync(self):
        """Carry the reference's new documents and messages across (the
        port's log drops what it already holds; its summaries are its
        own uploads)."""
        known = {d for d in self.ref_service.doc_ids()
                 if self.port_service.storage.latest(d)[0] is not None}
        corpus = export_corpus(self.ref_service)
        for doc_id in known:
            corpus[doc_id].pop("summary", None)
        load_service_corpus(self.port_service, corpus)

    def tier_stats(self, svc):
        return {name: getattr(svc, name).stats() for name in TIERS
                if getattr(svc, name) is not None}

    def catch_up(self, doc_ids=None, **kw):
        """Both services over the same request; returns the port's
        results after asserting parity."""
        self.sync()
        r_stats, p_stats = {}, {}
        ref = self.ref.catch_up(doc_ids, stats=r_stats, **kw)
        got = self.port.catch_up(doc_ids, stats=p_stats, **kw)
        assert got == ref
        assert p_stats == r_stats
        for name in COUNTERS:
            assert getattr(self.port, name) == getattr(self.ref, name), name
        assert self.port.pipeline_stats == self.ref.pipeline_stats
        assert set(self.port.pipeline_stage) == \
            port_stage_keys(self.ref.pipeline_stage)
        for key in ("h2d_bytes", "d2h_bytes"):
            assert self.port.pipeline_stage.get(key) == \
                self.ref.pipeline_stage.get(key), key
        assert self.tier_stats(self.port) == self.tier_stats(self.ref)
        return got
