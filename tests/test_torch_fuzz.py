"""The port's fuzz harness and mock runtimes
(``fluidframework_tpu_torch.testing.fuzz`` / ``.mocks``) against the JAX
package's: each of tests/test_fuzz.py's eight specs, at its seeds, client
counts and rounds, gives the same sequencer log, the same channel log
(``channel_log``) and the same final replica digests in both packages;
the string, map and matrix logs then fold through the port's plain
entries (``device="cpu"``) to the reference replica's digest.  Also: the
mock runtime's own surface (partial delivery, the pending count, the
MSN advance), and the corpus generators of tests/torch_corpora.py built
by each package's harness, equal document for document.
"""

import pytest
import torch

import fluidframework_tpu.testing.fuzz as ref_fuzz
import fluidframework_tpu.testing.mocks as ref_mocks
import fluidframework_tpu_torch.testing as port_testing
import fluidframework_tpu_torch.testing.fuzz as port_fuzz
import fluidframework_tpu_torch.testing.mocks as port_mocks
from fluidframework_tpu_torch.ops import map_kernel as mp
from fluidframework_tpu_torch.ops import matrix_kernel as mk
from fluidframework_tpu_torch.ops import mergetree_kernel as mt
from tests import torch_corpora

torch.set_num_threads(1)


def _message(m):
    return (m.seq, m.client_id, m.client_seq, m.ref_seq, m.min_seq,
            m.type.value, m.contents, m.timestamp)


def _run(fuzz, mocks, spec_name, spec_kw, **run_kw):
    replicas, factory = fuzz.run_fuzz(
        getattr(fuzz, spec_name)(**spec_kw), **run_kw)
    return {"log": [_message(m) for m in factory.sequencer.log],
            "channel": [_message(m)
                        for m in mocks.channel_log(factory, "fuzz")],
            "digests": [r.summarize().digest() for r in replicas],
            "final": (factory.sequencer.seq, factory.sequencer.min_seq)}, \
        factory


def _fold(spec_name, factory, want):
    """The port's plain fold of the port's channel log, against the
    reference replica's digest (``want``)."""
    ops = port_mocks.channel_log(factory, "fuzz")
    seq, msn = factory.sequencer.seq, factory.sequencer.min_seq
    if spec_name == "StringFuzzSpec":
        [got] = mt.replay_mergetree_batch([mt.MergeTreeDocInput(
            doc_id="fuzz", ops=ops, final_seq=seq, final_msn=msn)],
            device="cpu")
    elif spec_name == "MapFuzzSpec":
        [got] = mp.replay_map_batch([mp.MapDocInput(doc_id="fuzz", ops=ops)],
                                    device="cpu")
    elif spec_name == "MatrixFuzzSpec":
        [got] = mk.replay_matrix_batch([mk.MatrixDocInput(
            doc_id="fuzz", ops=ops, final_seq=seq, final_msn=msn)],
            device="cpu")
    else:
        return
    assert got.digest() == want


#: tests/test_fuzz.py: (spec, spec keywords, seeds, clients, rounds)
CASES = {
    "shared_string": ("StringFuzzSpec", {}, range(8), 3, 40),
    "shared_string_many_clients": ("StringFuzzSpec", {},
                                   range(1000, 1004), 5, 25),
    "shared_map": ("MapFuzzSpec", {}, range(4), 4, 30),
    "shared_directory": ("DirectoryFuzzSpec", {}, range(4), 3, 30),
    "matrix": ("MatrixFuzzSpec", {}, range(6), 3, 30),
    "matrix_fww": ("MatrixFuzzSpec", {"fww": True}, range(500, 504), 3, 30),
    "consensus_registers": ("RegisterFuzzSpec", {}, range(700, 704), 4, 30),
    "consensus_queue": ("QueueFuzzSpec", {}, range(800, 804), 3, 30),
}


@pytest.mark.parametrize("seed,case", [
    (seed, case) for case, (_s, _k, seeds, _c, _r) in CASES.items()
    for seed in seeds])
def test_fuzz_logs_and_digests_match_the_reference(case, seed):
    spec_name, spec_kw, _seeds, n_clients, rounds = CASES[case]
    want, _ = _run(ref_fuzz, ref_mocks, spec_name, spec_kw, seed=seed,
                   n_clients=n_clients, rounds=rounds)
    got, factory = _run(port_fuzz, port_mocks, spec_name, spec_kw,
                        seed=seed, n_clients=n_clients, rounds=rounds)
    assert got == want
    assert len(set(got["digests"])) == 1  # the replicas converged
    _fold(spec_name, factory, want["digests"][0])


def test_mock_runtime_partial_delivery_matches_the_reference():
    """Interleavings under the test's control: some messages delivered,
    concurrent edits, the rest delivered, the MSN advanced; the same
    texts, pending counts and logs in both packages."""
    from fluidframework_tpu.dds.sequence import SharedString as RefString
    from fluidframework_tpu_torch.dds.sequence import (
        SharedString as PortString)

    def scenario(mocks, string_cls):
        f = mocks.MockContainerRuntimeFactory()
        a = f.create_client("alice").attach(string_cls("doc"))
        b = f.create_client("bob").attach(string_cls("doc"))
        a.insert_text(0, "hello")
        b.insert_text(0, "[x] ")
        seen = [f.pending_count]
        f.process_some_messages(1)
        seen.append(f.pending_count)
        a.insert_text(1, "Y")
        f.process_all_messages()
        seen.append(f.pending_count)
        f.advance_min_seq()
        assert a.text == b.text
        assert a.summarize().digest() == b.summarize().digest()
        return (seen, a.text, a.summarize().digest(),
                [_message(m) for m in f.sequencer.log],
                [_message(m) for m in mocks.channel_log(f, "doc")])

    assert scenario(port_mocks, PortString) == scenario(ref_mocks, RefString)
    assert port_testing.MockContainerRuntimeFactory \
        is port_mocks.MockContainerRuntimeFactory
    assert port_testing.MockClientRuntime is port_mocks.MockClientRuntime


CORPORA = {
    "fold_fuzz-0": lambda: torch_corpora.fold_fuzz_docs(0),
    "intervals": lambda: torch_corpora.interval_docs(range(2)),
    "warm": lambda: [torch_corpora.warm_doc()],
}


def _doc(d):
    return {f: ([_message(m) for m in v] if f == "ops" else v)
            for f, v in vars(d).items() if f != "port_twin"}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_both_generators_give_identical_corpora(corpus):
    """tests/torch_corpora.py's fuzz corpora, built by each package's own
    harness: every document's fields and messages equal, so the port's
    side of a parity test is the port's own generator's output."""
    docs = CORPORA[corpus]()
    assert docs
    for ref_doc in docs:
        assert _doc(ref_doc.port_twin) == _doc(ref_doc)
