"""Every seed of a cell does the same amount of work (CPU).

For each cell and six seeds: the pools have the same document and op
counts and the same annotating share; they pack, in the entry's own
order and chunks, to the same S / T / K buckets, layout facts and upload
bytes; the frozen fold-work count of a fixed sample moves little from
seed to seed (its spread is printed); and one seed gives the same bytes
twice.

    python3 -m pytest portbench/tests/test_portbench_seeds.py -q -s
"""

import statistics

import numpy as np
import pytest

from portbench import run

SEEDS = (1, 2 ** 31 + 11, 3_000_000_019, 77, 2 ** 32 - 5, 123_456_789)
#: the benchmark's cells
CELLS = ("string_long.cold",)
#: documents whose fold work is counted a seed (each costs ~0.5 s in the
#: reference)
WORK_DOCS = 3
FACTS = ("i16_ok", "i8_ok", "ob_rows", "ov_rows", "has_props", "props_K")


def _shape_of(spec, seed):
    from fluidframework_tpu_torch.ops.mergetree_kernel import (
        narrow_ops_for_upload, pack_mergetree_batch)
    from fluidframework_tpu_torch.ops.pipeline import MERGETREE_FAMILY

    driver = __import__(spec.config["driver"], fromlist=["inputs"])
    pool = driver.generate(spec.config, spec.traffic, seed)
    docs = driver.inputs(pool)
    order = MERGETREE_FAMILY.order(docs, True)
    chunks = []
    for lo in range(0, len(order), 1024):
        chunk = [docs[i] for i in order[lo:lo + 1024]]
        _state, ops, meta = pack_mergetree_batch(chunk)
        narrow = narrow_ops_for_upload(ops, meta)
        h2d = int(sum(np.asarray(x).nbytes for x in narrow))
        chunks.append((meta["_S"], ops.kind.shape, h2d,
                       tuple(meta.get(f) for f in FACTS)))
    return pool, chunks, driver.work(pool, range(WORK_DOCS))[
        "int_ops_per_op"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_seed_does_the_same_work(cell):
    spec = run.load_cell(cell)
    shapes, per_op = [], []
    for seed in SEEDS:
        pool, chunks, work_per_op = _shape_of(spec, seed)
        assert pool.n_docs == spec.config["docs"]
        assert pool.n_ops == spec.config["ops_per_doc"]
        assert int(pool.annotating.sum()) == int(
            (np.arange(pool.n_docs) % 10 >= 7).sum())
        assert all(len(b) > 0 for b in pool.blobs)
        shapes.append(chunks)
        per_op.append(work_per_op)
    assert all(s == shapes[0] for s in shapes[1:]), shapes
    spread = (max(per_op) - min(per_op)) / statistics.median(per_op)
    print(f"\n{cell}: chunks (S, [D, T], h2d bytes, facts) {shapes[0]}")
    print(f"{cell}: fold work a op over {WORK_DOCS} documents, "
          f"6 seeds: {[round(x, 1) for x in per_op]}, spread "
          f"{spread:.4f} of the median")
    assert spread < 0.25


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_one_seed_gives_the_same_bytes(cell):
    spec = run.load_cell(cell)
    driver = __import__(spec.config["driver"], fromlist=["generate"])
    a = driver.generate(spec.config, spec.traffic, 2 ** 31 + 3, n_docs=256)
    b = driver.generate(spec.config, spec.traffic, 2 ** 31 + 3, n_docs=256)
    c = driver.generate(spec.config, spec.traffic, 2 ** 31 + 4, n_docs=256)
    assert a.blobs == b.blobs and a.values == b.values
    assert np.array_equal(a.final_len, b.final_len)
    assert a.blobs != c.blobs
