"""The benchmark's frozen copies agree with their originals today (CPU).

- the reference's summary digests equal the port's ``dds/`` oracle's on
  32 documents of the cell's tails and of short ones;
- the generator's record streams equal ``encode_string_ops``'s bytes and
  intern tables;
- the fold-work count equals ``chip_smoke.fold_work_of``'s.

This is the only file of the benchmark that imports the originals.

    python3 -m pytest portbench/tests/test_portbench_frozen.py -q
"""

import pytest

from portbench import generator, run
from portbench.reference import sharedstring as ref
from portbench.work import FoldWork

CELL = "string_long.cold"
#: ops a document: the cell's own tails, and short ones
TAILS = {"long": None, "short": 96}
SEED = 2 ** 31 + 2024


def _messages(records):
    from fluidframework_tpu_torch.protocol.messages import (
        MessageType, SequencedMessage)

    out = []
    for kind, seq, client, ref_seq, a, b, text, props in records:
        contents = {
            generator.INSERT: {"kind": "insert", "pos": a, "text": text},
            generator.REMOVE: {"kind": "remove", "start": a, "end": b},
            generator.ANNOTATE: {"kind": "annotate", "start": a, "end": b,
                                 "props": props},
        }[kind]
        out.append(SequencedMessage(
            seq=seq, client_id=client, client_seq=seq, ref_seq=ref_seq,
            min_seq=0, type=MessageType.OP, contents=contents))
    return out


def _pool(tail, n_docs):
    spec = run.load_cell(CELL)
    driver = __import__(spec.config["driver"], fromlist=["generate"])
    pool = driver.generate(spec.config, spec.traffic, SEED, n_docs=n_docs,
                           n_ops=TAILS[tail])
    return driver, pool


@pytest.mark.parametrize("tail", sorted(TAILS))
def test_reference_digests_equal_the_oracle(tail):
    from fluidframework_tpu_torch.testing.workload import oracle_replay

    driver, pool = _pool(tail, 32)
    docs = driver.inputs(pool)
    for d in range(pool.n_docs):
        want = oracle_replay(docs[d]).summarize()
        got = driver.reference(pool, d)
        assert got == {"header": want.blob_bytes("header"),
                       "body": want.blob_bytes("body")}
        assert ref.digest(got) == want.digest()


@pytest.mark.parametrize("tail", sorted(TAILS))
def test_encoder_bytes_equal_the_port_encoder(tail):
    from fluidframework_tpu_torch.ops.interning import Interner
    from fluidframework_tpu_torch.ops.native_pack import encode_string_ops

    _driver, pool = _pool(tail, 40)
    for d in range(pool.n_docs):
        clients, keys, values = Interner(), Interner(), Interner()
        blob = encode_string_ops(_messages(pool.records(d)), clients, keys,
                                 values)
        assert blob == pool.blobs[d]
        assert list(clients.values) == pool.clients
        assert (list(values.values) or None) == pool.values[d]
        assert (list(keys.values) or None) == (
            [pool.prop_key] if pool.values[d] else None)


@pytest.mark.parametrize("tail,n_docs", [("short", 32), ("long", 10)])
def test_work_count_equals_chip_smoke(tail, n_docs):
    import chip_smoke
    from fluidframework_tpu_torch.convert import tensors_to
    from fluidframework_tpu_torch.ops.mergetree_kernel import (
        pack_mergetree_batch)

    driver, pool = _pool(tail, n_docs)
    docs = driver.inputs(pool)
    # one batch of annotate-free documents and one of annotating ones, as
    # the entry's schedule chunks them
    for group in (~pool.annotating, pool.annotating):
        idx = [int(d) for d in group.nonzero()[0]]
        if not idx:
            continue
        state, ops, _meta = pack_mergetree_batch([docs[d] for d in idx])
        want_ops, want_slots = chip_smoke.fold_work_of(
            tensors_to(state, "cpu"), tensors_to(ops, "cpu"))
        work = FoldWork()
        for d in idx:
            ref.replay(pool.records(d), pool.n_ops, work=work)
        assert (work.int_ops, work.live_slots) == (want_ops, want_slots)
