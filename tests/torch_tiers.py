"""Shared harness for the port's cache-tier parity tests
(tests/test_torch_pack_cache.py, test_torch_delta_download.py,
test_torch_device_cache.py, test_torch_tree_pipeline.py).

A ``TierPair`` holds one set of cache tiers for the JAX package and one
for the port, built alike for one kernel family (merge-tree by default,
or the tree), and runs every call of a sequence through both pipelines
(the reference's on CPU JAX, the port's with ``device="cpu"``) on the
same documents.  Each call asserts equal summary bytes, equal
``stats`` (``device_docs``, ``fallback_docs``, ``delta_docs``), equal
``h2d_bytes`` / ``d2h_bytes`` and an equal ``stats()`` dict for every
tier.
"""

import bench
from fluidframework_tpu.ops.device_cache import DevicePackCache as RefDevice
from fluidframework_tpu.ops.mergetree_kernel import MergeTreeDocInput
from fluidframework_tpu.ops.pipeline import PackCache as RefPack
from fluidframework_tpu.ops.pipeline import (
    pipelined_mergetree_replay as ref_pipeline)
from fluidframework_tpu.ops.tree_pipeline import TREE_FAMILY as REF_TREE
from fluidframework_tpu.ops.tree_pipeline import TreeDeviceOps as RefTreeOps
from fluidframework_tpu.ops.tree_pipeline import (
    pipelined_tree_replay as ref_tree_pipeline)
from fluidframework_tpu.service.catchup_cache import (
    DeltaExportCache as RefDelta)
from fluidframework_tpu_torch.convert import tree_doc_input_from
from fluidframework_tpu_torch.ops.device_cache import DevicePackCache
from fluidframework_tpu_torch.ops.pipeline import (
    PackCache,
    pipelined_mergetree_replay,
)
from fluidframework_tpu_torch.ops.tree_pipeline import (
    TREE_FAMILY,
    TreeDeviceOps,
    pipelined_tree_replay,
)
from fluidframework_tpu_torch.service.catchup_cache import DeltaExportCache
from tests.torch_corpora import port_docs, port_stage_keys

TIERS = ("pack_cache", "delta_cache", "device_cache")


def streams(n_docs, n_ops):
    """The pinned workload's op streams (bench.synth_doc), as messages."""
    return [bench.doc_ops(bench.synth_doc(i, n_ops)) for i in range(n_docs)]


def window(streams_, i, n_ops, epoch="ep"):
    """Document ``i``'s first ``n_ops`` ops under a stable cache token."""
    msgs = streams_[i][:n_ops]
    return MergeTreeDocInput(
        doc_id=f"d{i}", ops=msgs, final_seq=msgs[-1].seq, final_msn=0,
        cache_token=(epoch, f"d{i}", 0, ""),
    )


def corpus(streams_, lo, hi=None, grown=(), epoch="ep"):
    """Every document at ``lo`` ops, the ``grown`` ones at ``hi``."""
    return [window(streams_, i, hi if i in grown else lo, epoch)
            for i in range(len(streams_))]


class TierPair:
    """Matching cache tiers for the reference and the port, for the
    merge-tree family or (``tree=True``) the tree family."""

    def __init__(self, pack=True, delta=False, device=False,
                 pack_kw=None, delta_kw=None, device_kw=None, tree=False):
        pack_kw, delta_kw = pack_kw or {}, delta_kw or {}
        device_kw = device_kw or {}
        self.tree = tree
        if tree:
            pack_kw = dict(pack_kw)
            ref_pack_kw = dict(pack_kw, family=REF_TREE)
            pack_kw["family"] = TREE_FAMILY
            ref_dev_kw = dict(device_kw, device_ops=RefTreeOps())
            device_kw = dict(device_kw, device_ops=TreeDeviceOps())
        else:
            ref_pack_kw, ref_dev_kw = pack_kw, device_kw
        self.ref = {
            "pack_cache": RefPack(**ref_pack_kw) if pack else None,
            "delta_cache": RefDelta(**delta_kw) if delta else None,
            "device_cache": RefDevice(**ref_dev_kw) if device else None,
        }
        self.port = {
            "pack_cache": PackCache(**pack_kw) if pack else None,
            "delta_cache": DeltaExportCache(**delta_kw) if delta else None,
            "device_cache": DevicePackCache(device="cpu", **device_kw)
            if device else None,
        }

    def tier_stats(self, side):
        tiers = self.ref if side == "ref" else self.port
        return {name: tier.stats() for name, tier in tiers.items()
                if tier is not None}

    def run(self, ref_docs, chunk_docs=8, pin_resident=False, **kw):
        """Both pipelines over ``ref_docs``; returns the port's
        ``(digests, stage, stats)`` after asserting parity."""
        r_stage, r_stats, p_stage, p_stats = {}, {}, {}, {}
        ref_fn, port_fn, convert = \
            (ref_tree_pipeline, pipelined_tree_replay,
             lambda ds: [tree_doc_input_from(d) for d in ds]) \
            if self.tree else \
            (ref_pipeline, pipelined_mergetree_replay, port_docs)
        ref = ref_fn(ref_docs, chunk_docs=chunk_docs, stage=r_stage,
                     stats=r_stats, pin_resident=pin_resident,
                     **self.ref, **kw)
        got = port_fn(
            convert(ref_docs), chunk_docs=chunk_docs, stage=p_stage,
            stats=p_stats, pin_resident=pin_resident, device="cpu",
            **self.port, **kw)
        digests = [s.digest() for s in got]
        assert digests == [s.digest() for s in ref]
        assert p_stats == r_stats
        assert set(p_stage) == port_stage_keys(r_stage)
        for key in ("h2d_bytes", "d2h_bytes"):
            assert p_stage[key] == r_stage[key], key
        assert self.tier_stats("port") == self.tier_stats("ref")
        return digests, p_stage, p_stats
