#!/usr/bin/env python3
"""Time the port's merge-tree fold kernel against builds of it that answer
one question each, in one process on one card.

Run from the root of a checkout, on a machine with an NVIDIA GPU::

    python3 tools/torch_fold_variants.py [--baseline OLD.cu]

It builds, with the kernel's own nvcc flags and all at once:

- ``kernel``: ``fluidframework_tpu_torch/csrc/mergetree_fold.cu`` as it is
  (its state-out build in shared memory, the one every variant changes);
- ``baseline`` (with ``--baseline``): another source of the kernel with the
  same C interface, such as an earlier commit's, unpacked by
  ``git archive`` into a directory ``.gitignore`` lists;
- three variants made from the kernel's source by textual edits (an edit
  that no longer applies stops the run):
  ``copy_only`` skips every op row, so it times the bulk copies in and out
  alone, at the kernel's occupancy; ``second_stage_smem`` reserves a second
  state and op tile a document, the shared memory a prefetching second
  stage would need, and so runs at that design's occupancy;
  ``phase_cycles`` adds ``clock64()`` counters around the load, the view,
  the insert's neighbour search, the two kinds of move and the store,
  summed over all warps.

On the pinned batch (10,240 documents x 96 ops, S = 192, K = 1) every
build that folds (all but ``copy_only``) must give the kernel's result bit
for bit.  Each build is then timed in turns, in the order given and then
reversed (baseline, kernel, ..., ..., kernel, baseline), two ways, both
with CUDA events and each a median over its launches:

- ``device_ms``: each launch behind a ~1 ms device spin, so the events
  bound the kernel alone and not the host's time to enqueue it;
- ``call_ms``: no spin, so the host's time in the wrapper and the C entry
  counts wherever the device waits for it.

It prints one JSON line: the card, the times, the compiler's register
report, the occupancy of each build that exports the query, and the
shares of a warp's cycles by phase.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DOCS, N_OPS = 10240, 96
SPIN_CYCLES = 2_000_000  # device clock cycles, ~1 ms at 1.98 GHz
PHASES = ("load", "view", "kill", "move_ins", "move_range", "store")
KERNEL_SRC = os.path.join(REPO, "fluidframework_tpu_torch", "csrc",
                          "mergetree_fold.cu")


def _edit(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant edit no longer applies: {old!r}")
        text = text.replace(old, new)
    return text


def _phase_cycle_edits():
    return [
        ("constexpr unsigned kFull = 0xffffffffu;\n",
         "constexpr unsigned kFull = 0xffffffffu;\n"
         "__device__ unsigned long long g_cyc[8];\n"),
        ("  int n;\n  bool overflow;\n",
         "  int n;\n  bool overflow;\n"
         "  long long cyc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"),
        ("      load(t0, tl, t0 == 0);\n",
         "      long long c_ = clock64();\n      load(t0, tl, t0 == 0);\n"
         "      cyc[0] += clock64() - c_;\n"),
        ("      const View w = take_view(",
         "      long long c0_ = clock64();\n      const View w = take_view("),
        ("      const bool cut_a = w.ia >= 0;\n",
         "      long long c1_ = clock64();\n      cyc[1] += c1_ - c0_;\n"
         "      const bool cut_a = w.ia >= 0;\n"),
        ("        move_and_stamp(doc, r, w, cut_a, false,",
         "        long long c2_ = clock64();\n        cyc[2] += c2_ - c1_;\n"
         "        move_and_stamp(doc, r, w, cut_a, false,"),
        ("        if (lane == 0 && w.ja < S) {",
         "        cyc[3] += clock64() - c2_;\n        cyc[6] += 1;\n"
         "        if (lane == 0 && w.ja < S) {"),
        ("        const bool over = move_and_stamp(",
         "        long long c2_ = clock64();\n"
         "        const bool over = move_and_stamp("),
        ("        overflow |= __any_sync(kFull, over) != 0;\n",
         "        cyc[4] += clock64() - c2_;\n        cyc[7] += 1;\n"
         "        overflow |= __any_sync(kFull, over) != 0;\n"),
        ("  if constexpr (kExport) {\n",
         "  long long c5_ = clock64();\n  if constexpr (kExport) {\n"),
        ("      args.ov_out[d] = overflow ? 1 : 0;\n    }\n  }\n}\n",
         "      args.ov_out[d] = overflow ? 1 : 0;\n    }\n  }\n"
         "  __syncwarp();\n"
         "  cyc[5] += clock64() - c5_;\n  if (lane == 0)\n"
         "    for (int i = 0; i < 8; ++i)\n"
         "      atomicAdd(&g_cyc[i], (unsigned long long)cyc[i]);\n}\n"),
        ('extern "C" {\n',
         'extern "C" {\n\nint mergetree_fold_cycles(unsigned long long* out) '
         '{\n  return (int)cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc));'
         '\n}\n'),
    ]


def sources(baseline: str | None) -> dict:
    """Build name -> CUDA source, in timing order."""
    with open(KERNEL_SRC) as f:
        src = f.read()
    out = {}
    if baseline:
        with open(baseline) as f:
            out["baseline"] = f.read()
    out["kernel"] = src
    out["copy_only"] = _edit(src, [(
        "if (r.kind < K_INSERT || r.kind > K_OBLITERATE) continue;",
        "continue;")])
    out["second_stage_smem"] = _edit(src, [(
        "+ (size_t)(N_OPF + K) * kOpTile;",
        "+ 2 * (size_t)(N_OPF + K) * kOpTile"
        " + (size_t)(N_FIXED + K) * S;")])
    out["phase_cycles"] = _edit(src, _phase_cycle_edits())
    return out


def build_all(texts: dict, out_dir: str) -> dict:
    """Compile every source with the kernel's nvcc flags, all at once;
    returns name -> (bound library, ptxas register lines)."""
    from fluidframework_tpu_torch.ops import _cuda_build, fold_cuda

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_cuda_build.nvcc_path(), *_cuda_build.NVCC_FLAGS, "-o",
             os.path.join(out_dir, f"lib{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        # Builds of this source answer the occupancy query; an older
        # baseline may not.
        lib = fold_cuda.bind_all(lib) \
            if hasattr(lib, "mergetree_fold_occupancy_of") \
            else fold_cuda.bind(lib)
        built[name] = (lib, [ln.strip() for ln in log.splitlines()
                             if "registers" in ln])
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="another source of the kernel "
                    "with the same C interface, timed beside it")
    ap.add_argument("--reps", type=int, default=7,
                    help="timed launches per build, per turn and method")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_fold_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from fluidframework_tpu_torch.convert import tensors_to
    from fluidframework_tpu_torch.ops import fold_cuda
    from fluidframework_tpu_torch.ops import mergetree_kernel as mt
    from fluidframework_tpu_torch.ops.native_pack import BUILD_DIR
    from fluidframework_tpu_torch.testing import workload

    built = build_all(sources(args.baseline),
                      os.path.join(BUILD_DIR, "fold_variants"))
    libs = {name: lib for name, (lib, _) in built.items()}
    docs = [workload.synth_doc(i, N_OPS) for i in range(N_DOCS)]
    st_np, ops_np, _meta = mt.pack_mergetree_batch(docs)
    S = st_np.tstart.shape[1]
    ops = tensors_to(ops_np, "cuda")
    state = mt.cold_start(ops, S)

    want = fold_cuda.fold(state, ops, lib=libs["kernel"])
    for name, lib in libs.items():
        got = fold_cuda.fold(state, ops, lib=lib)
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(want, f), getattr(got, f))
                   for f in want._fields)
        if name != "copy_only" and not same:
            raise AssertionError(f"{name} does not fold as the kernel does")

    def timed(lib, spin):
        for _ in range(2):
            fold_cuda.fold(state, ops, lib=lib)
        torch.cuda.synchronize()
        runs = []
        for _ in range(args.reps):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            if spin:
                torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fold_cuda.fold(state, ops, lib=lib)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        return runs

    methods = {"device_ms": True, "call_ms": False}
    runs = {m: {name: [] for name in libs} for m in methods}
    order = list(libs)
    for name in order + order[::-1]:
        for m, spin in methods.items():
            runs[m][name] += timed(libs[name], spin)

    cycles = (ctypes.c_ulonglong * 8)()
    counted = libs["phase_cycles"]
    counted.mergetree_fold_cycles.argtypes = [ctypes.c_void_p]
    # The counters add up over every launch: read them around one.
    if counted.mergetree_fold_cycles(cycles) != 0:
        raise RuntimeError("reading the phase counters failed")
    before = list(cycles)
    fold_cuda.fold(state, ops, lib=counted)
    torch.cuda.synchronize()
    if counted.mergetree_fold_cycles(cycles) != 0:
        raise RuntimeError("reading the phase counters failed")
    one = [a - b for a, b in zip(cycles, before)]
    total = sum(one[:len(PHASES)])
    ins_rows, range_rows = one[6], one[7]
    occupancy = {name: fold_cuda.occupancy(S, 1, lib=lib)
                 for name, lib in libs.items()
                 if hasattr(lib, "mergetree_fold_occupancy_of")}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "fold_variants": True, "card": card,
        "shape": [N_DOCS] + list(st_np.props.shape[1:]) + [N_OPS],
        "order": order + order[::-1],
        "median_ms": {m: {n: statistics.median(r) for n, r in by.items()}
                      for m, by in runs.items()},
        "runs_ms": runs,
        "ptxas": {n: regs for n, (_, regs) in built.items()},
        "occupancy": occupancy,
        "phase_share": {p: one[i] / total for i, p in enumerate(PHASES)},
        "cycles_per_row": {
            "view": one[1] / (ins_rows + range_rows),
            "kill": one[2] / ins_rows, "move_ins": one[3] / ins_rows,
            "move_range": one[4] / range_rows},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
