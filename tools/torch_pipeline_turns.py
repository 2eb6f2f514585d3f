#!/usr/bin/env python3
"""Time the port's two catch-up entry points, and the pipeline at other
thread counts, in turns in one process on one card.

Run from the root of a checkout, on a machine with an NVIDIA GPU::

    python3 tools/torch_pipeline_turns.py

Over the pinned workload (10,240 documents x 96 ops) it runs, in the
order given and then reversed, ``ROUNDS`` times:

- ``batch``: ``replay_mergetree_batch`` (one batch, every leg serial);
- ``pipe_4_3``: ``pipelined_mergetree_replay`` with the reference's
  defaults (4 pack threads, 3 extract threads);
- ``pipe_1_1``, ``pipe_1_3``, ``pipe_4_1``: the same with other pool
  sizes, to tell which pool's threads contend.

Each run is timed on the host clock around work that ends in
``torch.cuda.synchronize()``; a pipelined run also reports its stage
dict (busy seconds per leg, summed over the pool's threads).  It prints
one JSON line: the card, each configuration's rates (ops/s) in run
order, their medians, and the median stage seconds.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DOCS, N_OPS = 10240, 96
CONFIGS = {"batch": None, "pipe_4_3": (4, 3), "pipe_1_1": (1, 1),
           "pipe_1_3": (1, 3), "pipe_4_1": (4, 1)}
#: passes over the configurations, each forward then reversed
ROUNDS = 2


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_pipeline_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from fluidframework_tpu_torch.ops import mergetree_kernel as mt
    from fluidframework_tpu_torch.ops.pipeline import (
        pipelined_mergetree_replay)
    from fluidframework_tpu_torch.testing import workload

    docs = [workload.synth_doc(i, N_OPS) for i in range(N_DOCS)]
    n_ops = N_DOCS * N_OPS

    def run(name):
        threads = CONFIGS[name]
        stage = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        if threads is None:
            mt.replay_mergetree_batch(docs)
        else:
            pipelined_mergetree_replay(docs, pack_threads=threads[0],
                                       extract_threads=threads[1],
                                       stage=stage)
        torch.cuda.synchronize()
        return n_ops / (time.perf_counter() - t), stage

    run("batch")  # builds the libraries and warms the allocators
    run("pipe_4_3")
    order = list(CONFIGS)
    rates = {name: [] for name in order}
    stages = {name: [] for name in order}
    turns = []
    for _ in range(ROUNDS):
        for name in order + order[::-1]:
            rate, stage = run(name)
            rates[name].append(rate)
            stages[name].append(stage)
            turns.append(name)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "pipeline_turns": True, "card": card, "docs": N_DOCS,
        "ops": n_ops, "turns": turns, "ops_per_s": rates,
        "median_ops_per_s": {n: statistics.median(r)
                             for n, r in rates.items()},
        "median_stage_s": {
            n: {k: statistics.median(s[k] for s in st)
                for k in st[0] if not k.endswith("_bytes")}
            for n, st in stages.items() if st and st[0]},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
