"""The control: the plain reference in the system's place, one op stale.

The configurations state that every sequenced op up to the head is in
the caught-up summary.  The control breaks that guarantee the way a
shortcut would (a summary that leaves out the newest op), and the check
must call it not correct.  ``control_pass(pool)`` is a pass function
shaped like the system's entry, for a whole run in the system's place
(the tests, at a small pool).  At a cell's own size the command below
reads the control on the answers a run compares (the run's sample, drawn
from each seed) and prints one JSON line a seed:

    python3 -m portbench.control --workload string_long.cold \
        --seeds 11,12,13
"""

from __future__ import annotations

import argparse
import importlib
import json
import time
from types import SimpleNamespace
from typing import Dict, List


def _answer(blobs: Dict[str, bytes]) -> SimpleNamespace:
    """Blobs shaped as a summary tree (``children`` of ``content``)."""
    return SimpleNamespace(children={
        name: SimpleNamespace(content=body) for name, body in blobs.items()})


def control_pass(driver, pool):
    """A pass function that answers every document with the control."""
    index = {f"doc{d}": d for d in range(pool.n_docs)}

    def run_pass(docs, device, stage, stats) -> List:
        return [_answer(driver.reference(pool, index[doc.doc_id],
                                         control=True))
                for doc in docs]

    return run_pass


def read_control(spec, seed: int) -> dict:
    """The control's readings on the answers a run of ``seed`` compares
    whole (the run's sample), judged by the run's own ``judge``."""
    from .run import draw_sample, judge

    driver = importlib.import_module(spec.config["driver"])
    pool = driver.generate(spec.config, spec.traffic, seed)
    sample = draw_sample(pool.n_docs, int(spec.config["check_sample_docs"]),
                         seed, driver.longest(pool))
    t0 = time.perf_counter()
    answers = {d: driver.keep(_answer(driver.reference(pool, d,
                                                       control=True)), True)
               for d in sample}
    check, _bad, _ops, compared = judge(driver, pool, [answers], sample,
                                        sample)
    return {"workload": spec.name, "seed": seed, "compared": compared,
            **{name: c["value"] for name, c in check.items()},
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    from .run import load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    for seed in args.seeds.split(","):
        print(json.dumps(read_control(spec, int(seed))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
