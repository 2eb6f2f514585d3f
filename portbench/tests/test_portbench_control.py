"""The check calls the control and every fault of the timed path not
correct (CPU, small pools).

The control is the plain reference in the system's place with the
newest op left out (``portbench.control``).  The faults are planted in
the system underneath a whole run that skips the look for a card
(``device="cpu"``):

- a fold that returns its state unchanged (no op row applied);
- half of the batch left out, its answers missing, or copied from the
  other half;
- an answer altered where it is produced (one text byte of every body);
- one visible character of every answer outside the sample altered;
- a token altered where it is produced (every document's newest op row
  dropped in the pack).

The exchange between chips has no fault here: every cell runs on one.

    python3 -m pytest portbench/tests/test_portbench_control.py -q
"""

import dataclasses
import json
import time

import numpy as np
import pytest

from portbench import control, run

SEEDS = (2 ** 31 + 5, 3_000_000_007, 41)
#: the benchmark's cell at (documents, ops a document) small enough for
#: the CPU fold: short tails, and longer ones
SIZES = {"short": (40, 96), "long": (12, 240)}
CELL = "string_long.cold"


def _run(size, seed):
    n_docs, n_ops = SIZES[size]
    return run.run_cell(run.load_cell(CELL), seed, 0.0, False, "cpu",
                        time.perf_counter(), n_docs=n_docs, n_ops=n_ops)[0]


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("seed", SEEDS)
def test_the_program_reads_correct(size, seed):
    res = _run(size, seed)
    assert res["correct"] is True
    assert all(c["value"] == 0 for c in res["check"].values())


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_reads_not_correct(size, seed, monkeypatch):
    import portbench.sharedstring as driver

    spec = run.load_cell(CELL)
    n_docs, n_ops = SIZES[size]
    pool = driver.generate(spec.config, spec.traffic, seed, n_docs=n_docs,
                           n_ops=n_ops)
    monkeypatch.setattr(driver, "entry",
                        lambda traffic: control.control_pass(driver, pool))
    res = _run(size, seed)
    assert res["correct"] is False
    assert res["check"]["sample_mismatch"]["value"] == min(
        n_docs, spec.config["check_sample_docs"])
    assert res["check"]["header_mismatch"]["value"] > 0
    assert res["check"]["text_mismatch"]["value"] > 0


def _family(monkeypatch, **fields):
    from fluidframework_tpu_torch.ops import pipeline

    monkeypatch.setattr(pipeline, "MERGETREE_FAMILY", dataclasses.replace(
        pipeline.MERGETREE_FAMILY, **fields))
    return pipeline


def _state_unchanged(monkeypatch):
    from fluidframework_tpu_torch.ops import pipeline
    pack = pipeline.MERGETREE_FAMILY.pack

    def no_rows(chunk):
        state, ops, meta = pack(chunk)
        return state, ops._replace(kind=np.zeros_like(ops.kind)), meta

    _family(monkeypatch, pack=no_rows)


def _half_batch(monkeypatch, fill):
    from fluidframework_tpu_torch.ops import pipeline
    entry = pipeline.pipelined_mergetree_replay

    def half(docs, **kw):
        got = entry(docs[:len(docs) // 2], **kw)
        rest = len(docs) - len(got)
        return got + (got[:rest] if fill else [None] * rest)

    monkeypatch.setattr(pipeline, "pipelined_mergetree_replay", half)


def _answer_altered(monkeypatch):
    from fluidframework_tpu_torch.ops import pipeline
    extract = pipeline.MERGETREE_FAMILY.extract

    def altered(meta, arr, st):
        out = extract(meta, arr, st)
        for summary in out:
            blob = summary.children["body"]
            i = blob.content.find(b'"t":"') + 5
            flip = b"b" if blob.content[i:i + 1] == b"a" else b"a"
            blob.content = blob.content[:i] + flip + blob.content[i + 1:]
        return out

    _family(monkeypatch, extract=altered)


def _text_altered_outside_sample(monkeypatch, sample):
    """One visible character of every answer outside the sample altered:
    only the visible-text check can see it."""
    from fluidframework_tpu_torch.ops import pipeline
    from portbench.reference.sharedstring import canonical_json
    entry = pipeline.pipelined_mergetree_replay

    def altered(docs, **kw):
        out = entry(docs, **kw)
        for d, summary in enumerate(out):
            if d in sample:
                continue
            blob = summary.children["body"]
            records = json.loads(blob.content)
            seg = next(r for r in records if "rs" not in r and r["t"])
            seg["t"] = ("b" if seg["t"][0] == "a" else "a") + seg["t"][1:]
            blob.content = canonical_json(records)
        return out

    monkeypatch.setattr(pipeline, "pipelined_mergetree_replay", altered)


def _token_altered(monkeypatch):
    from fluidframework_tpu_torch.ops import pipeline
    pack = pipeline.MERGETREE_FAMILY.pack

    def drop_newest(chunk):
        state, ops, meta = pack(chunk)
        kind = ops.kind.copy()
        last = np.count_nonzero(kind, axis=1) - 1
        kind[np.arange(len(kind)), last] = 0
        return state, ops._replace(kind=kind), meta

    _family(monkeypatch, pack=drop_newest)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_batch_missing": lambda mp: _half_batch(mp, fill=False),
          "half_batch_copied": lambda mp: _half_batch(mp, fill=True),
          "answer_altered": _answer_altered, "token_altered": _token_altered}


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_reads_not_correct(size, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(size, SEEDS[0])
    assert res["correct"] is False, res["check"]
    assert res["failed"] > 0
    if fault == "half_batch_missing":
        assert res["check"]["missing"]["value"] == res["attempted"] // 2


@pytest.mark.parametrize("n_ops", (96, 240))
def test_a_text_fault_outside_the_sample_reads_not_correct(n_ops,
                                                           monkeypatch):
    spec = run.load_cell(CELL)
    driver = __import__(spec.config["driver"], fromlist=["generate"])
    seed, n_docs = SEEDS[1], 32
    pool = driver.generate(spec.config, spec.traffic, seed, n_docs=n_docs,
                           n_ops=n_ops)
    sample = set(run.draw_sample(n_docs, spec.config["check_sample_docs"],
                                 seed, driver.longest(pool)))
    assert len(sample) < n_docs
    _text_altered_outside_sample(monkeypatch, sample)
    res = run.run_cell(spec, seed, 0.0, False, "cpu", time.perf_counter(),
                       n_docs=n_docs, n_ops=n_ops)[0]
    assert res["correct"] is False, res["check"]
    assert res["check"]["text_mismatch"]["value"] > 0
    assert res["check"]["sample_mismatch"]["value"] == 0
    assert res["check"]["header_mismatch"]["value"] == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_the_spliced_text_is_the_reference_text(seed):
    spec = run.load_cell(CELL)
    driver = __import__(spec.config["driver"], fromlist=["generate"])
    pool = driver.generate(spec.config, spec.traffic, seed, n_docs=12,
                           n_ops=300)
    for d in range(pool.n_docs):
        text = driver.visible_text(driver.reference(pool, d)["body"])
        assert text == pool.final_text(d)
        assert len(text) == int(pool.final_len[d])
