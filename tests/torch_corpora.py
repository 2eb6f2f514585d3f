"""Shared corpora for the PyTorch port's parity tests (tests/test_torch_*).

Every corpus is built twice from the same seeds: once as the JAX
package's ``MergeTreeDocInput``s and once as the port's, so both sides
fold the same inputs.  A corpus drawn from the fuzz harness is generated
by each package's own harness (``GENERATORS``: its ``fuzz``, ``mocks``,
doc inputs and ``SharedString``), the port's documents riding on the
reference's as ``port_twin``; any other corpus is converted by attribute
name (``convert.doc_input_from``).  ``port_docs`` hands the port its
side either way.
"""

import importlib.util
import json
import pathlib

import numpy as np
import torch

import bench
import types

import fluidframework_tpu.dds.sequence as ref_sequence
import fluidframework_tpu.ops.map_kernel as ref_map_kernel
import fluidframework_tpu.ops.matrix_kernel as ref_matrix_kernel
import fluidframework_tpu.testing.fuzz as ref_fuzz
import fluidframework_tpu.testing.mocks as ref_mocks
import fluidframework_tpu_torch.dds.sequence as port_sequence
import fluidframework_tpu_torch.ops.map_kernel as port_map_kernel
import fluidframework_tpu_torch.ops.matrix_kernel as port_matrix_kernel
import fluidframework_tpu_torch.ops.mergetree_kernel as port_mergetree_kernel
import fluidframework_tpu_torch.testing.fuzz as port_fuzz
import fluidframework_tpu_torch.testing.mocks as port_mocks
from fluidframework_tpu.ops.mergetree_kernel import MergeTreeDocInput
from fluidframework_tpu.protocol.messages import MessageType, SequencedMessage
from fluidframework_tpu_torch.convert import doc_input_from
from fluidframework_tpu_torch.testing import workload

ROOT = pathlib.Path(__file__).resolve().parents[1]

# The CPU folds here run on small tensors, where torch's intra-op thread
# pool costs several times the work it splits (and the test workers
# already share the cores).
torch.set_num_threads(1)


def _generator(fuzz, mocks, sequence, mergetree_input, map_kernel,
               matrix_kernel):
    return types.SimpleNamespace(
        fuzz=fuzz, run_fuzz=fuzz.run_fuzz, channel_log=mocks.channel_log,
        SharedString=sequence.SharedString, MergeTreeDocInput=mergetree_input,
        MapDocInput=map_kernel.MapDocInput,
        MatrixDocInput=matrix_kernel.MatrixDocInput)


#: each package's own generator of fuzz corpora: (reference, port)
GENERATORS = (
    _generator(ref_fuzz, ref_mocks, ref_sequence, MergeTreeDocInput,
               ref_map_kernel, ref_matrix_kernel),
    _generator(port_fuzz, port_mocks, port_sequence,
               port_mergetree_kernel.MergeTreeDocInput, port_map_kernel,
               port_matrix_kernel),
)


def twinned(build):
    """``build(gen)`` with each package's generator: the reference's
    documents, each carrying the port's build of it as ``port_twin``."""
    ref, port = (build(gen) for gen in GENERATORS)
    for r, p in zip(ref, port, strict=True):
        r.port_twin = p
    return ref


def port_twin(doc, convert):
    """The port's side of a reference document: its ``port_twin`` when
    the port's own generator built one, else ``convert(doc)``."""
    twin = getattr(doc, "port_twin", None)
    return twin if twin is not None else convert(doc)


def graft_entry():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_docs(n_docs, n_ops):
    return [bench.synth_doc(i, n_ops) for i in range(n_docs)]


def hard_docs():
    return graft_entry()._hard_mergetree_docs()


def overflow_doc():
    """The JAX-package twin of ``workload.overflow_doc`` (three removers of
    one range at ref 1)."""
    return reference_doc(workload.overflow_doc())


def reference_doc(port_doc):
    """A JAX-package doc input copied from a port one (by attribute)."""
    return MergeTreeDocInput(
        doc_id=port_doc.doc_id,
        ops=[SequencedMessage(
            seq=m.seq, client_id=m.client_id, client_seq=m.client_seq,
            ref_seq=m.ref_seq, min_seq=m.min_seq,
            type=MessageType(m.type.value), contents=m.contents,
            timestamp=m.timestamp) for m in port_doc.ops],
        base_records=port_doc.base_records, final_seq=port_doc.final_seq,
        final_msn=port_doc.final_msn, base_seq=port_doc.base_seq,
        base_msn=port_doc.base_msn, base_intervals=port_doc.base_intervals,
        binary_ops=port_doc.binary_ops,
        binary_clients=port_doc.binary_clients,
        binary_prop_keys=port_doc.binary_prop_keys,
        binary_values=port_doc.binary_values,
    )


def fuzz_doc(gen, doc_id, spec, **run):
    """One fuzz run's op log as ``gen``'s merge-tree doc input."""
    _r, factory = gen.run_fuzz(spec, **run)
    return gen.MergeTreeDocInput(
        doc_id=doc_id, ops=gen.channel_log(factory, "fuzz"),
        final_seq=factory.sequencer.seq,
        final_msn=factory.sequencer.min_seq,
    )


def fold_fuzz_docs(seed):
    """The fuzz logs of tests/test_pallas_fold.py (annotate- and
    obliterate-carrying, lagged by ``sync_every=2``)."""
    return twinned(lambda gen: [
        fuzz_doc(gen, f"fz{i}", spec, seed=1300 + 10 * seed + i,
                 n_clients=3, rounds=8, sync_every=2)
        for i, spec in enumerate((gen.fuzz.StringFuzzSpec(annotate=True),
                                  gen.fuzz.StringFuzzSpec(obliterate=True)))])


def interval_docs(seeds=range(3)):
    """Interval-carrying fuzz logs, as tests/test_mergetree_kernel.py."""
    return twinned(lambda gen: [
        fuzz_doc(gen, f"iv{seed}", gen.fuzz.StringFuzzSpec(intervals=True),
                 seed=900 + seed, n_clients=3, rounds=25)
        for seed in seeds])


def _warm_doc(gen, seed):
    _r, factory = gen.run_fuzz(gen.fuzz.StringFuzzSpec(), seed=seed,
                               n_clients=3, rounds=16)
    ops = gen.channel_log(factory, "fuzz")
    mid_seq = ops[len(ops) // 2].seq
    partial = gen.SharedString("fuzz")
    for m in ops:
        if m.seq <= mid_seq:
            partial.process(m, local=False)
    return gen.MergeTreeDocInput(
        doc_id="warm",
        ops=[m for m in ops if m.seq > mid_seq],
        base_records=json.loads(partial.summarize().blob_bytes("body")),
        base_seq=partial.tree.current_seq, base_msn=partial.tree.min_seq,
        final_seq=factory.sequencer.seq,
        final_msn=factory.sequencer.min_seq,
    )


def warm_doc(seed=9):
    """A base summary at the midpoint plus the op tail after it."""
    [doc] = twinned(lambda gen: [_warm_doc(gen, seed)])
    return doc


#: the fold-parity corpora, by name
FOLD_CORPORA = {
    "bench-24x48": lambda: bench_docs(24, 48),
    "hard": hard_docs,
    "fuzz-0": lambda: fold_fuzz_docs(0),
    "fuzz-1": lambda: fold_fuzz_docs(1),
    "fuzz-2": lambda: fold_fuzz_docs(2),
    "nondivisible-11x24": lambda: bench_docs(11, 24),
    "overflow": lambda: [overflow_doc()],
}


def port_docs(ref_docs):
    return [port_twin(d, doc_input_from) for d in ref_docs]


def port_stage_keys(ref_stage) -> set:
    """The keys the port's stage dict holds where the reference's holds
    ``ref_stage``'s: the same keys, plus the port's CPU twins of the pack
    and extract legs and its ``extract_tasks``, ``extract_nodes``,
    ``extract_native_docs`` and ``pack_tasks`` counters wherever the stage
    schema was seeded."""
    from fluidframework_tpu_torch.ops.pipeline import (EXTRACT_STAGE_COUNTS,
                                                       HOST_CPU_KEYS,
                                                       STAGE_KEYS)

    keys = set(ref_stage)
    if set(STAGE_KEYS) <= keys:
        keys |= set(HOST_CPU_KEYS) | {"extract_tasks", "pack_tasks"} \
            | set(EXTRACT_STAGE_COUNTS)
    return keys


def assert_states_equal(ref, got, n_docs):
    """Slots [0, n) of every plane, plus ``n`` and ``overflow``, exactly
    (the comparator of tests/test_pallas_fold.py)."""
    for field in ref._fields:
        a = np.asarray(getattr(ref, field))
        b = getattr(got, field).cpu().numpy()
        assert a.shape == b.shape, field
        if field in ("n", "overflow"):
            np.testing.assert_array_equal(a, b, err_msg=field)
            continue
        for d in range(n_docs):
            nd = int(np.asarray(ref.n)[d])
            np.testing.assert_array_equal(a[d, :nd], b[d, :nd],
                                          err_msg=f"{field} doc {d}")
