#!/usr/bin/env python3
"""Time the port's hand-written kernels in turns, on one card.

The SharedTree edit-fold (K5, ``csrc/tree_fold.cu``), the SharedMap LWW
reduction (K7, ``csrc/map_lww.cu``), the SharedMatrix resolving axis
fold (K4, ``csrc/matrix_fold.cu``) and the resident splice and widen
(K6, ``csrc/resident.cu``), each beside builds of it that answer one
question each, in one process.

Run from the root of a checkout, on a machine with an NVIDIA GPU::

    python3 tools/torch_kernel_turns.py [--kernels tree,map,matrix,resident]
        [--tree-baseline OTHER_tree_fold.cu] [--map-baseline OTHER_map_lww.cu]
        [--matrix-baseline OTHER_matrix_fold.cu]
        [--resident-baseline OTHER_resident.cu]
        [--tree-wide N C ...] [--reps 7]

A baseline is another source of a kernel with its current C entry, timed
beside it and launched by its current wrapper: an earlier commit's, say,
unpacked by ``git archive`` into a directory ``.gitignore`` lists
(``tools/torch_fold_variants.py --baseline`` does the same for the
merge-tree fold).  Without one, a family times its kernel and the builds
below.  ``--kernels`` picks the families to run (all by default).  The
tool builds, with the kernels' own nvcc flags and all at once:

- ``tree`` and ``map``: the sources as they are, and ``tree_baseline`` /
  ``map_baseline`` when named; ``tree_gmem`` is the ``tree`` build with
  every forest in device memory (``InDeviceMemory``), to time the
  placements;
- three builds of the tree source made by textual edits: ``copy_only``
  skips the fold of every edit row, so it times the copies in and out and
  the digest alone; ``no_walk_table`` takes the lean shared-memory
  layout (the walk over the planes) at every shape; ``phase_cycles`` adds
  ``clock64()`` counters around the copy in (with the decode and the walk
  table), the reads of the decoded rows, their application without the
  ancestor walk, the walk, the write-back and the digest, summed over all
  warps, with the slowest document's total;
- three builds of the map source that split its time (``MAP_VARIANTS``:
  the memset alone, without the key pass, without the atomics);
- ``matrix`` (K4), ``matrix_baseline`` when named, the
  ``MATRIX_VARIANTS`` builds of the source (another block-team width,
  register cap or op-tile height) and a ``phase_cycles`` build (the
  source's own ``-DMATRIX_FOLD_CYCLES`` counters around the copy in, the
  resolve rows, the folding rows' view, arrival kill and move, and the
  write-back, summed over all streams, with the rows counted and the
  slowest stream's total);
- ``resident`` (K6), ``resident_baseline`` when named, and a
  ``phase_cycles`` build (the source's ``-DRESIDENT_CYCLES`` counters: per
  thread, its cycles, the cycles of the copies (splice) or of the rebase
  test (widen), the elements it visited and wrote, summed, with the
  slowest thread's total).

The inputs are ``chip_smoke.py``'s: the tree kernel's pinned chunk (the
first 1,024 documents the tree workload dispatches, 48 edits each,
N = 256, C = 128, T = 64), the map phase's batch (10,240 x
``gen_map_doc(i, 96)``), the matrix phase's main batch (10,240 x
``gen_matrix_doc(i, 64)``: 20,480 streams, S = 128, T = 64) and its
S = 4,096 batch (16 x ``gen_matrix_doc(i, 2048)``), and the warm phase's
first chunk (1,024 pinned documents, 80-op windows, every 8th grown to
96 ops: the grown suffix spliced into 10 int32 planes, and the cold
chunk's narrow ops widened).  ``--tree-wide N C`` also times the same chunk
with its planes padded to N node rows and C container rows, as the packer
pads a chunk to its widest document's buckets (each build in its own
placement there).  Every build that folds must give the kernel's result
bit for bit (both tree builds, fold and fold + digest, at every shape;
every output of the map reduction; every plane and resolved handle of
the matrix fold, cold and warm; every splice and widen plane).  Then
every build is timed in turns, in the order built and then reversed, two
ways, both with CUDA events and each a median over its launches:

- ``device_ms``: each launch behind a ~1 ms device spin, so the events
  bound the kernel alone and not the host's time to enqueue it;
- ``call_ms``: no spin, so the host's time in the wrapper and the C entry
  counts wherever the device waits for it.

It prints one JSON line: the card, the times, the compiler's register
report, the phase splits and, for K4, the warps each build keeps resident
on an SM.
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
CSRC = os.path.join(REPO, "fluidframework_tpu_torch", "csrc")
SPIN_CYCLES = 2_000_000  # device clock cycles, ~1 ms at 1.98 GHz
TREE_DOCS, TREE_EDITS, CHUNK_DOCS = 1280, 48, 1024
MAP_DOCS, MAP_OPS = 10240, 96
MATRIX_DOCS, MATRIX_OPS = 10240, 64
MATRIX_GMEM_DOCS, MATRIX_GMEM_OPS = 16, 2048
#: the warm phase's first chunk (chip_smoke.py: 80-op windows of the
#: pinned documents, every 8th grown to 96 ops)
WARM_DOCS, WARM_OPS, WARM_BASE_OPS, GROW_EVERY = 1024, 96, 80, 8
#: the counters the phase build keeps (one slot each in ``g_cyc``)
PHASES = ("copy_in", "rows", "apply", "walk", "write_back", "digest")
COUNTERS = PHASES + ("edit_rows", "slowest_doc", "docs", "walk_steps")

_CYC_DECL = "__device__ unsigned long long g_cyc[10];\n"
_CYC_ENTRY = ('extern "C" {\n\nint tree_fold_cycles(unsigned long long* out)'
              ' {\n  return (int)cudaMemcpyFromSymbol(out, g_cyc, '
              'sizeof(g_cyc));\n}\n')
# lane 0's counters, added to g_cyc once a warp (the slowest document's
# total by atomicMax)
_CYC_FLUSH = (
    "  if (lane == 0) {\n"
    "    unsigned long long tot_ = 0;\n"
    "    for (int i = 0; i < 6; ++i) tot_ += (unsigned long long)cyc_[i];\n"
    "    for (int i = 0; i < 6; ++i)\n"
    "      atomicAdd(&g_cyc[i], (unsigned long long)cyc_[i]);\n"
    "    atomicAdd(&g_cyc[6], (unsigned long long)rows_);\n"
    "    atomicMax(&g_cyc[7], tot_);\n"
    "    atomicAdd(&g_cyc[8], 1ull);\n"
    "    atomicAdd(&g_cyc[9], (unsigned long long)steps_);\n"
    "  }\n")

#: Edit sets for the tree source as it stands (the warp decodes the rows,
#: lane 0 reads them from shared memory, the walk reads a table).
#: ``copy_in`` also holds the decode and the walk table's build, ``rows``
#: the reads of the decoded rows and the tiles after the first, and
#: ``write_back`` the wait for the bulk stores (they drain while the
#: digest is formed).
_TREE_TILE_PHASES = [
    ("constexpr int kWalkUnroll = 4;",
     _CYC_DECL + "constexpr int kWalkUnroll = 4;"),
    ("__device__ __forceinline__ void walk(const SmemForest& f, int owner, "
     "int jo,\n                                     int first, bool& hit, "
     "bool& alive) {\n",
     "__device__ __forceinline__ void walk(const SmemForest& f, int owner, "
     "int jo,\n                                     int first, bool& hit, "
     "bool& alive,\n                                     long long& steps_) "
     "{\n"),
    ("      hit |= live & (cur == first);\n",
     "      hit |= live & (cur == first);\n      steps_ += live;\n"),
    ("    plane_walk(f, owner, first, hit, alive);\n    return;\n",
     "    plane_walk(f, owner, first, hit, alive, steps_);\n    return;\n"),
    ("__device__ __forceinline__ void walk(const GmemForest& f, int owner, "
     "int,\n                                     int first, bool& hit, "
     "bool& alive) {\n  plane_walk(f, owner, first, hit, alive);\n",
     "__device__ __forceinline__ void walk(const GmemForest& f, int owner, "
     "int,\n                                     int first, bool& hit, "
     "bool& alive,\n                                     long long& steps_) "
     "{\n  plane_walk(f, owner, first, hit, alive, steps_);\n"),
    ("__device__ __forceinline__ void plane_walk(const F& f, int owner, "
     "int first,\n                                           bool& hit, "
     "bool& alive) {\n",
     "__device__ __forceinline__ void plane_walk(const F& f, int owner, "
     "int first,\n                                           bool& hit, "
     "bool& alive,\n                                           "
     "long long& steps_) {\n"),
    ("  for (int k = 0; k < kMaxDepth && alive; ++k) {\n"
     "    hit |= cur == first;\n",
     "  for (int k = 0; k < kMaxDepth && alive; ++k) {\n    ++steps_;\n"
     "    hit |= cur == first;\n"),
    ("__device__ __forceinline__ bool apply_edit(const F& f, const Row& r) "
     "{\n",
     "__device__ __forceinline__ bool apply_edit(const F& f, const Row& r,\n"
     "                                           long long& wc_,\n"
     "                                           long long& steps_) {\n"),
    ("  walk(f, owner, jo, r.first, hit, alive);\n",
     "  const long long w0_ = clock64();\n"
     "  walk(f, owner, jo, r.first, hit, alive, steps_);\n"
     "  wc_ += clock64() - w0_;\n"),
    ("  const bool bulk = !kGmem && a.bulk;\n",
     "  const bool bulk = !kGmem && a.bulk;\n"
     "  long long cyc_[6] = {0, 0, 0, 0, 0, 0}, wc_ = 0, steps_ = 0;\n"
     "  int rows_ = 0;\n  const long long c0_ = clock64();\n"),
    ("  // Lane 0 folds; the next row is read while the current one applies.\n",
     "  cyc_[0] = clock64() - c0_;\n  const long long l0_ = clock64();\n"
     "  // Lane 0 folds; the next row is read while the current one applies.\n"),
    ("        overflow |= apply_edit(f, r);\n",
     "        const long long a0_ = clock64();\n"
     "        overflow |= apply_edit(f, r, wc_, steps_);\n"
     "        cyc_[2] += clock64() - a0_;\n        rows_ += r.kind != 0;\n"),
    ("  overflow = __shfl_sync(kFull, (int)overflow, 0) != 0;\n",
     "  cyc_[1] = clock64() - l0_ - cyc_[2];\n  cyc_[2] -= wc_;\n"
     "  cyc_[3] = wc_;\n"
     "  overflow = __shfl_sync(kFull, (int)overflow, 0) != 0;\n"
     "  const long long b0_ = clock64();\n"),
    ("  if (lane == 0) a.out_overflow[d] = overflow;\n"
     "  if (kDigest) write_digest(f, a, d, lane, overflow);\n",
     "  if (lane == 0) a.out_overflow[d] = overflow;\n"
     "  cyc_[4] = clock64() - b0_;\n  const long long g0_ = clock64();\n"
     "  if (kDigest) write_digest(f, a, d, lane, overflow);\n"
     "  __syncwarp();\n  cyc_[5] = clock64() - g0_;\n"
     "  const long long e0_ = clock64();\n"),
    ("  if (bulk && lane < kPlanes) bulk_store_wait();\n}\n",
     "  if (bulk && lane < kPlanes) bulk_store_wait();\n  __syncwarp();\n"
     "  cyc_[4] += clock64() - e0_;\n" + _CYC_FLUSH + "}\n"),
    ('extern "C" {\n', _CYC_ENTRY),
]
_TREE_TILE_COPY_ONLY = [
    ("        overflow |= apply_edit(f, r);\n",
     "        overflow |= (r.kind ^ r.seq ^ r.c ^ r.anchor ^ r.first ^ "
     "r.tail ^ r.value ^ r.purge) == 0x7fffffff;\n"),
]

#: Builds of the map source that split its time (their outputs are not
#: the reduction's): ``memset_only`` launches no kernel, ``rows_only`` no
#: key pass, ``no_atomics`` keeps the row pass's warp reductions but
#: issues no atomic.
MAP_VARIANTS = {
    "memset_only": [
        ("  rows_kernel<<<blocks_for(rows), kThreads, 0, s>>>(a);\n", ""),
        ("  keys_kernel<<<blocks_for(G), kThreads, 0, s>>>(a);\n", "")],
    "rows_only": [
        ("  keys_kernel<<<blocks_for(G), kThreads, 0, s>>>(a);\n", "")],
    "no_atomics": [
        ("    if (lead) {\n",
         "    if (lead && (hi ^ lo ^ smax ^ vmax) == 0x9E3779B9u) {\n")],
}

#: the counters of the K4 phase builds (one slot each in ``g_cyc``): the
#: cycles of each part, the rows of each sort, the slowest stream's total
#: and the streams counted
K4_PARTS = ("copy_in", "resolve", "view", "kill", "move", "write_back")
K4_COUNTERS = K4_PARTS + ("resolve_rows", "fold_rows", "slowest_stream",
                          "streams")

#: the counters of the K6 phase builds: per thread, its cycles, the
#: cycles of its copies (splice) or rebase tests (widen), the elements it
#: visited and wrote; then the slowest thread's cycles and the threads
K6_COUNTERS = ("thread_cycles", "part_cycles", "visited", "written",
               "slowest_thread", "threads")

#: Builds of csrc/matrix_fold.cu that try other choices: another block-team
#: width at S > 128 (S / 4 or S / 32 threads in place of S / 16), a looser
#: register cap for the warp teams (3 blocks of 256 threads an SM, not 4:
#: 85 registers), and a 32-row op tile (not 64: less shared memory a
#: stream, more streams an SM)
MATRIX_VARIANTS = {
    **{f"team_s{k}": [("  int threads = (S / 16 + 31) / 32 * 32;\n",
                       f"  int threads = (S / {k} + 31) / 32 * 32;\n")]
       for k in (4, 32)},
    "regs85": [("                                  kMode == 0 ? 4 : 1)",
                "                                  kMode == 0 ? 3 : 1)")],
    "tile32": [("constexpr int kTile = 64;", "constexpr int kTile = 32;")],
}

#: the lean shared-memory layout (no walk table) at every shape
_TREE_NO_WALK_TABLE = [
    ("  if (doc_words(N, C, false, kTile, true) * 4 <= kSmemLimit) "
     "return;\n", ""),
]

#: name -> the edit set of each build of the tree source
TREE_VARIANTS = {"copy_only": _TREE_TILE_COPY_ONLY,
                 "phase_cycles": _TREE_TILE_PHASES,
                 "no_walk_table": _TREE_NO_WALK_TABLE}


def _apply(text: str, edits):
    """The source with every edit made, or None when one does not apply."""
    for old, new in edits:
        if text.count(old) != 1:
            return None
        text = text.replace(old, new)
    return text


class InDeviceMemory:
    """A tree build whose every forest folds in device memory (the C
    entry's ``gmem`` set whatever the wrapper's placement), to time the
    placements against each other on one shape."""

    def __init__(self, lib):
        self.lib = lib

    def tree_fold(self, ptrs, D, N, C, T, gmem, docs_per_block, stream):
        return self.lib.tree_fold(ptrs, D, N, C, T, 1, docs_per_block,
                                  stream)


FAMILIES = ("tree", "map", "matrix", "resident")
#: each family's source in csrc/, the builds made from it by textual edits,
#: and the flag that builds its own phase counters in
SOURCES = {"tree": "tree_fold.cu", "map": "map_lww.cu",
           "matrix": "matrix_fold.cu", "resident": "resident.cu"}
VARIANTS = {"tree": TREE_VARIANTS, "map": MAP_VARIANTS,
            "matrix": MATRIX_VARIANTS, "resident": {}}
CYCLE_FLAGS = {"matrix": "-DMATRIX_FOLD_CYCLES",
               "resident": "-DRESIDENT_CYCLES"}


def sources(args) -> dict:
    """Build name -> (kind, CUDA source, extra nvcc flags), in timing
    order, for the families ``args.kernels`` names."""
    def read(path):
        with open(path) as f:
            return f.read()

    def edited(text, edits, what):
        made = _apply(text, edits)
        if made is None:
            raise RuntimeError(f"the {what} edits do not apply")
        return made

    out = {}
    for family in args.kernels:
        src = read(os.path.join(CSRC, SOURCES[family]))
        out[family] = (family, src, ())
        baseline = getattr(args, f"{family}_baseline")
        if baseline:
            out[f"{family}_baseline"] = (family, read(baseline), ())
        for variant, edits in VARIANTS[family].items():
            out[f"{family}_{variant}"] = (family, edited(
                src, edits, f"{variant} (csrc/{SOURCES[family]})"), ())
        if family in CYCLE_FLAGS:
            out[f"{family}_phase_cycles"] = (family, src,
                                             (CYCLE_FLAGS[family],))
    return out


def build_all(texts: dict, out_dir: str) -> dict:
    """Compile every source with the kernels' nvcc flags, all at once;
    returns name -> (bound library, ptxas lines)."""
    from fluidframework_tpu_torch.ops import (_cuda_build, map_lww_cuda,
                                              matrix_fold_cuda, resident_cuda,
                                              tree_fold_cuda)

    binders = {"tree": tree_fold_cuda.bind, "map": map_lww_cuda.bind,
               "matrix": matrix_fold_cuda.bind,
               "resident": resident_cuda.bind}
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (_kind, text, flags) in texts.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_cuda_build.nvcc_path(), *_cuda_build.NVCC_FLAGS, *flags, "-o",
             os.path.join(out_dir, f"lib{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        built[name] = (binders[texts[name][0]](lib),
                       [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln])
    return built


def tree_chunk():
    """The tree kernel's pinned chunk on the host: the first
    ``CHUNK_DOCS`` documents of the tree workload's base windows that the
    pipeline dispatches (the tree family keeps their order), packed, with
    the digest's used-row counts."""
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.testing import tree_workload as tw

    base, _grown = tw.tree_windows(TREE_DOCS, TREE_EDITS)
    chunk = [d for d in base if not tk.known_tree_fallback(d)][:CHUNK_DOCS]
    if len(chunk) != CHUNK_DOCS:
        raise RuntimeError(f"{len(chunk)} tree documents dispatched, want "
                           f"{CHUNK_DOCS}")
    st, ed, meta = tk.pack_tree_batch(chunk)
    return st, ed, (meta["n_nodes"], meta["n_cont"])


def widen(st, ed, N: int, C: int):
    """The chunk's forest planes padded to ``N`` node rows and ``C``
    container rows with the packer's fill values, as a chunk holding a
    wider document is packed; the edits stay as they are."""
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    D, N0 = st.next.shape
    C0 = st.head.shape[1]
    if N < N0 or C < C0:
        raise ValueError(f"cannot narrow a [{N0}, {C0}] chunk to [{N}, {C}]")
    wide, _ = tk.empty_tree_arrays(D, N, C, ed.kind.shape[1])
    for f, x in st._asdict().items():
        if f != "overflow":
            wide[f][:, :x.shape[1]] = x
    wide["overflow"] = st.overflow.copy()
    return tk.TreeState(**wide), ed


def timed(fn, reps, spin):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    return runs


def in_turns(calls: dict, reps: int) -> dict:
    """``{method: {name: runs}}`` of every call, in the order given and
    then reversed, behind the spin and without it."""
    methods = {"device_ms": True, "call_ms": False}
    runs = {m: {name: [] for name in calls} for m in methods}
    order = list(calls)
    for name in order + order[::-1]:
        for m, spin in methods.items():
            runs[m][name] += timed(calls[name], reps, spin)
    return runs


def medians(runs: dict) -> dict:
    return {m: {n: statistics.median(r) for n, r in by.items()}
            for m, by in runs.items()}


def equal_leaves(want, got) -> bool:
    import torch

    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return len(want) == len(got) and all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        for a, b in zip(want, got))


def matrix_batches():
    """The matrix phase's two batches, packed on the host: ``main``
    (10,240 x ``gen_matrix_doc(i, 64)``) and ``large_s`` (16 x
    ``gen_matrix_doc(i, 2048)``)."""
    from fluidframework_tpu_torch.ops import matrix_kernel as mk
    from fluidframework_tpu_torch.testing import config_workloads as cw

    return {name: mk.pack_matrix_batch([cw.gen_matrix_doc(i, n_ops)
                                        for i in range(docs)])
            for name, docs, n_ops in (
                ("main", MATRIX_DOCS, MATRIX_OPS),
                ("large_s", MATRIX_GMEM_DOCS, MATRIX_GMEM_OPS))}


def warm_chunk():
    """The warm phase's first chunk on the host: 1,024 pinned documents
    as 80-op windows, every 8th grown to 96 ops.  Returns the grown op
    planes, the suffix rows past the cold windows (``gather_suffix_rows``),
    their start and count, and the cold chunk's narrow ops with its arena
    bases (what the migration widens)."""
    import numpy as np

    from fluidframework_tpu_torch.ops import mergetree_kernel as mt
    from fluidframework_tpu_torch.ops.device_cache import gather_suffix_rows
    from fluidframework_tpu_torch.testing import workload

    streams = [workload.doc_ops(workload.synth_doc(i, WARM_OPS))
               for i in range(WARM_DOCS)]

    def windows(grown):
        out = []
        for i, msgs in enumerate(streams):
            msgs = msgs[:WARM_OPS if grown and i % GROW_EVERY == 0
                        else WARM_BASE_OPS]
            out.append(mt.MergeTreeDocInput(doc_id=f"ddoc{i}", ops=msgs,
                                            final_seq=msgs[-1].seq))
        return out

    _s, cold_ops, cold_meta = mt.pack_mergetree_batch(windows(False))
    _s, grown_ops, _m = mt.pack_mergetree_batch(windows(True))
    t_old = np.count_nonzero(cold_ops.kind, axis=1).astype(np.int32)
    t_new = np.count_nonzero(grown_ops.kind, axis=1).astype(np.int32)
    rows, L = gather_suffix_rows(mt.MTOps, grown_ops, t_old, t_new)
    if rows is None or cold_ops.kind.shape != grown_ops.kind.shape:
        raise RuntimeError("the warm chunk does not splice")
    narrow = mt.narrow_ops_for_upload(cold_ops, cold_meta)
    if narrow.seq.dtype != np.int16:
        raise RuntimeError("the cold warm chunk did not narrow")
    return grown_ops, rows, t_old, t_new - t_old, narrow, \
        cold_meta["doc_base"]


def log(msg: str) -> None:
    """A progress line on stderr (the result is stdout's one line)."""
    print(f"torch_kernel_turns: {msg}", file=sys.stderr, flush=True)


def read_phases(lib, entry, counters, run) -> dict:
    """One run's counters of a phase build: ``entry`` reads and resets
    them, so it is called around ``run()``."""
    import torch

    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p]
    cycles = (ctypes.c_ulonglong * len(counters))()
    torch.cuda.synchronize()
    if fn(cycles) != 0:
        raise RuntimeError(f"{entry}: reading the counters failed")
    run()
    torch.cuda.synchronize()
    if fn(cycles) != 0:
        raise RuntimeError(f"{entry}: reading the counters failed")
    return dict(zip(counters, (int(c) for c in cycles)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default=",".join(FAMILIES),
                    help="the families to run, of " + ", ".join(FAMILIES))
    for family in FAMILIES:
        ap.add_argument(f"--{family}-baseline", metavar="PATH",
                        help=f"another source with the C entry of "
                        f"csrc/{SOURCES[family]}, timed beside it")
    ap.add_argument("--tree-wide", nargs=2, type=int, action="append",
                    metavar=("N", "C"), help="also time the pinned chunk "
                    "padded to N node rows and C container rows")
    ap.add_argument("--reps", type=int, default=7,
                    help="timed launches per build, per turn and method")
    args = ap.parse_args()
    args.kernels = [k for k in args.kernels.split(",") if k]
    unknown = set(args.kernels) - set(FAMILIES)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from fluidframework_tpu_torch.convert import tensors_to
    from fluidframework_tpu_torch.ops.native_pack import BUILD_DIR

    dev = torch.device("cuda")
    texts = sources(args)
    log(f"building {sorted(texts)}")
    built = build_all(texts, os.path.join(BUILD_DIR, "kernel_turns"))
    log("built")
    libs = {name: lib for name, (lib, _) in built.items()}
    parity, calls, phases, extra = {}, {}, {}, {}

    if "tree" in args.kernels:
        tree_section(args, dev, texts, libs, parity, calls, phases, extra)
    if "map" in args.kernels:
        map_section(dev, texts, libs, parity, calls)
    if "matrix" in args.kernels:
        matrix_section(dev, texts, libs, parity, calls, phases, extra,
                       tensors_to)
    if "resident" in args.kernels:
        resident_section(dev, texts, libs, parity, calls, phases, extra)
    log(f"parity {parity}")
    if not all(parity.values()):
        raise AssertionError(f"builds disagree with the kernel: {parity}")
    runs = in_turns(calls, args.reps)
    log("timed")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "kernel_turns": True, "card": card, "kernels": args.kernels,
        **extra, "parity": parity, "order": list(calls) + list(calls)[::-1],
        "median_ms": medians(runs), "runs_ms": runs,
        "ptxas": {n: regs for n, (_, regs) in built.items()},
        "phases": phases,
    }), flush=True)
    return 0


def tree_section(args, dev, texts, libs, parity, calls, phases, extra):
    """K5 and its builds: parity of every tree build, the calls to time,
    the phase split and the shapes."""
    import torch

    from fluidframework_tpu_torch.convert import tensors_to
    from fluidframework_tpu_torch.ops import tree_fold_cuda

    libs["tree_gmem"] = InDeviceMemory(libs["tree"])
    texts["tree_gmem"] = texts["tree"]
    tree_names = [n for n in libs if texts[n][0] == "tree"]

    st_np, ed_np, counts_np = tree_chunk()
    counts = tuple(torch.from_numpy(c).to(dev) for c in counts_np)
    shapes = {"pinned": (tensors_to(st_np, dev), tensors_to(ed_np, dev))}
    for N, C in args.tree_wide or ():
        st_w, ed_w = widen(st_np, ed_np, N, C)
        shapes[f"wide_{N}x{C}"] = (tensors_to(st_w, dev),
                                   tensors_to(ed_w, dev))

    def tree_call(name, digest, shape="pinned"):
        lib = libs[name]
        st, ed = shapes[shape]
        if digest:
            return lambda: tree_fold_cuda.fold_digest(st, ed, *counts,
                                                      lib=lib)
        return lambda: tree_fold_cuda.fold(st, ed, lib=lib)

    # every tree build that folds against the kernel, both entries, at
    # every shape (the phase build at the pinned chunk)
    for shape in shapes:
        for digest in (False, True):
            want = tree_call("tree", digest, shape)()
            for name in tree_names:
                if name.endswith("copy_only") or name == "tree" or (
                        shape != "pinned" and name.endswith("cycles")):
                    continue
                got = tree_call(name, digest, shape)()
                torch.cuda.synchronize()
                w = tuple(want[0]) + (want[1],) if digest else tuple(want)
                g = tuple(got[0]) + (got[1],) if digest else tuple(got)
                parity[f"{name}{'_digest' if digest else ''}@{shape}"] = \
                    equal_leaves(w, g)
    for shape in shapes:
        at = "" if shape == "pinned" else f"@{shape}"
        for name in tree_names:
            if name.endswith("phase_cycles") or (
                    at and name.endswith("copy_only")):
                continue
            calls[f"{name}{at}"] = tree_call(name, False, shape)
            calls[f"{name}_digest{at}"] = tree_call(name, True, shape)
    for name in tree_names:
        if not name.endswith("phase_cycles"):
            continue
        lib = libs[name]
        lib.tree_fold_cycles.argtypes = [ctypes.c_void_p]
        for digest in (False, True):
            cycles = (ctypes.c_ulonglong * len(COUNTERS))()
            # the sums run over every launch: read them around one
            if lib.tree_fold_cycles(cycles) != 0:
                raise RuntimeError("reading the phase counters failed")
            before = list(cycles)
            tree_call(name, digest)()
            torch.cuda.synchronize()
            if lib.tree_fold_cycles(cycles) != 0:
                raise RuntimeError("reading the phase counters failed")
            one = dict(zip(COUNTERS, (a - b for a, b in zip(cycles,
                                                             before))))
            # the slowest document's total is a maximum, not a sum
            one["slowest_doc"] = cycles[COUNTERS.index("slowest_doc")]
            total = sum(one[p] for p in PHASES)
            phases[f"{name}{'_digest' if digest else ''}"] = {
                "cycles": one,
                "share": {p: one[p] / total for p in PHASES},
                "mean_doc_cycles": total / max(1, one["docs"])}
    extra["tree_shapes"] = {k: [*v[0].next.shape, v[0].head.shape[1],
                                v[1].kind.shape[1]]
                            for k, v in shapes.items()}
    extra["tree_placement"] = {k: tree_fold_cuda.placement(
        v[0].next.shape[1], v[0].head.shape[1]) for k, v in shapes.items()}


def map_section(dev, texts, libs, parity, calls):
    """K7 and its builds: parity of every build that reduces, and the
    calls to time."""
    import torch

    from fluidframework_tpu_torch.ops import map_kernel as mp
    from fluidframework_tpu_torch.ops import map_lww_cuda
    from fluidframework_tpu_torch.testing import config_workloads as cw

    docs = [cw.gen_map_doc(i, MAP_OPS) for i in range(MAP_DOCS)]
    batch = mp.pack_map_batch(docs)
    inputs = mp.lww_inputs(batch, dev)
    map_names = [n for n in libs if texts[n][0] == "map"]
    map_want = map_lww_cuda.lww(inputs, batch.num_docs, lib=libs["map"])
    for name in map_names:
        if name[len("map_"):] in MAP_VARIANTS:
            continue
        got = map_lww_cuda.lww(inputs, batch.num_docs, lib=libs[name])
        torch.cuda.synchronize()
        parity[name] = equal_leaves(map_want, got)
    for name in map_names:
        calls[name] = (lambda lib: lambda: map_lww_cuda.lww(
            inputs, batch.num_docs, lib=lib))(libs[name])


def matrix_section(dev, texts, libs, parity, calls, phases, extra,
                   tensors_to):
    """K4 on the matrix phase's two batches: every build's planes and
    resolved handles equal to the kernel's cold fold (cold and warm: the
    same fill state read), the calls to time, each phase build's split and
    the warps each keeps resident on an SM."""
    import torch

    from fluidframework_tpu_torch.ops import matrix_fold_cuda

    names = [n for n in libs if texts[n][0] == "matrix"]
    batches = {}
    for label, (st_np, ops_np, meta) in matrix_batches().items():
        batches[label] = (tensors_to(st_np, dev), tensors_to(ops_np, dev),
                          st_np.tstart.shape[1], meta["cold"])

    def call(name, label, warm=False):
        state, ops, S, _cold = batches[label]
        lib = libs[name]
        if warm:
            return lambda: matrix_fold_cuda.fold_resolving(state, ops,
                                                           lib=lib)[:2]
        return lambda: matrix_fold_cuda.fold_resolving(
            None, ops, cold=True, S=S, lib=lib)[:2]

    def leaves(out):
        return tuple(out[0]) + (out[1],)

    occupancy, cold_flags = {}, {}
    for label, (_st, _ops, S, cold) in batches.items():
        cold_flags[label] = cold
        want = leaves(call("matrix", label)())
        for name in names:
            for warm in (False, True):
                if name == "matrix" and not warm:
                    continue
                log(f"K4 {name} {'warm' if warm else 'cold'} at {label}")
                got = leaves(call(name, label, warm)())
                torch.cuda.synchronize()
                parity[f"{name}{'_warm' if warm else ''}@{label}"] = \
                    equal_leaves(want, got)
        for name in names:
            if name.endswith("phase_cycles"):
                continue
            calls[f"{name}@{label}"] = call(name, label)
            calls[f"{name}_warm@{label}"] = call(name, label, True)
            occupancy[f"{name}@{label}"] = matrix_fold_cuda.occupancy(
                S, lib=libs[name])
        for name in names:
            if not name.endswith("phase_cycles"):
                continue
            for warm in (False, True):
                one = read_phases(libs[name], "matrix_fold_cycles",
                                  K4_COUNTERS, call(name, label, warm))
                total = sum(one[p] for p in K4_PARTS)
                phases[f"{name}{'_warm' if warm else ''}@{label}"] = {
                    "cycles": one,
                    "share": {p: one[p] / max(1, total) for p in K4_PARTS},
                    "mean_stream_cycles": total / max(1, one["streams"])}
    extra["matrix_shapes"] = {label: list(b[1].kind.shape[:1])
                              + [b[2], b[1].kind.shape[1]]
                              for label, b in batches.items()}
    extra["matrix_cold"] = cold_flags
    extra["matrix_occupancy"] = occupancy


def resident_section(dev, texts, libs, parity, calls, phases, extra):
    """K6 on the warm phase's first chunk: the splice of the grown suffix into 10 int32 planes (each build on its own
    copy, every element from each document's old count on bit-flipped
    first) and the migration of the cold chunk's narrow ops, every build
    equal to the plain versions; the calls to time and the phase splits."""
    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mt
    from fluidframework_tpu_torch.ops import resident_cuda

    grown_np, rows_np, start_np, count_np, narrow_np, base_np = warm_chunk()
    full = mt.MTOps(*(torch.from_numpy(x.copy()).to(dev) for x in grown_np))
    rows = mt.MTOps(**{f: torch.from_numpy(v).to(dev)
                       for f, v in rows_np.items()})
    start = torch.from_numpy(start_np).to(dev)
    count = torch.from_numpy(count_np).to(dev)
    narrow = mt.MTOps(*(torch.from_numpy(x.copy()).to(dev)
                        for x in narrow_np))
    base = torch.from_numpy(base_np).to(dev)

    def flipped_from(first):
        cut = torch.arange(full.kind.shape[1], device=dev)[None, :] \
            >= first[:, None]
        return mt.MTOps(*(torch.where(cut if x.ndim == 2 else cut[..., None],
                                      ~x, x) for x in full))

    flipped = flipped_from(start)
    restored = tuple(flipped_from(start + count))  # rows [start, +count)
    plain = mt.MTOps(*(x.clone() for x in flipped))
    resident_cuda.splice_rows_reference(plain, rows, start, count)
    want_widen = tuple(mt._widen_ops(narrow, base))
    names = [n for n in libs if texts[n][0] == "resident"]
    copies = {}
    for name in names:
        log(f"K6 {name}")
        lib = libs[name]
        mine = mt.MTOps(*(x.clone() for x in flipped))
        resident_cuda.splice_rows(mine, rows, start, count, lib=lib)
        got_w = resident_cuda.widen_resident(narrow, base, lib=lib)
        torch.cuda.synchronize()
        parity[f"{name}_splice"] = equal_leaves(tuple(plain), tuple(mine)) \
            and equal_leaves(restored, tuple(mine))
        parity[f"{name}_widen"] = equal_leaves(want_widen, tuple(got_w))
        copies[name] = mine
    for name in names:
        if name.endswith("_cycles"):
            continue
        lib, mine = libs[name], copies[name]
        calls[f"{name}_splice"] = (lambda lib, mine: lambda: (
            resident_cuda.splice_rows(mine, rows, start, count,
                                      lib=lib)))(lib, mine)
        calls[f"{name}_widen"] = (lambda lib: lambda: (
            resident_cuda.widen_resident(narrow, base, lib=lib)))(lib)
    for name in names:
        if not name.endswith("_cycles"):
            continue
        lib, mine = libs[name], copies[name]
        runs = {"splice": lambda: resident_cuda.splice_rows(
                    mine, rows, start, count, lib=lib),
                "widen": lambda: resident_cuda.widen_resident(
                    narrow, base, lib=lib)}
        for kernel, run in runs.items():
            one = read_phases(lib, "resident_cycles", K6_COUNTERS, run)
            phases[f"{name}@{kernel}"] = {
                "counters": one,
                "part_share": one["part_cycles"]
                / max(1, one["thread_cycles"]),
                "written_share": one["written"] / max(1, one["visited"])}
    extra["resident_shape"] = {
        "D": int(full.kind.shape[0]), "T": int(full.kind.shape[1]),
        "L": int(rows.kind.shape[1]), "planes": len(full),
        "rows": int(count.sum()), "widen_dtypes": sorted(
            {str(x.dtype) for x in narrow})}


if __name__ == "__main__":
    sys.exit(main())
