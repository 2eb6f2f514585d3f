#!/usr/bin/env python3
"""Time the port's SharedTree edit-fold (K5, ``csrc/tree_fold.cu``) and
SharedMap LWW reduction (K7, ``csrc/map_lww.cu``) against their earlier
designs, in turns, in one process on one card.

Run from the root of a checkout, on a machine with an NVIDIA GPU::

    python3 tools/torch_kernel_turns.py [--tree-baseline OTHER_tree_fold.cu]
        [--map-baseline OTHER_map_lww.cu] [--tree-wide N C ...] [--reps 7]

The baselines are the earlier designs kept in the repo
(``csrc/tree_fold_earlier.cu``, ``csrc/map_lww_earlier.cu``) unless
another source with the same C entry is named.  A tree baseline launches
by the earlier design's own rule (``tree_fold_cuda.EarlierLaunch``).  The
tool builds, with the kernels' own nvcc flags and all at once:

- ``tree`` and ``map``: the sources as they are; ``tree_baseline`` and
  ``map_baseline``; ``tree_gmem`` is the ``tree`` build with every forest
  in device memory (``InDeviceMemory``), to time the placements;
- three builds of the tree source made by textual edits: ``copy_only``
  skips the fold of every edit row, so it times the copies in and out and
  the digest alone; ``no_walk_table`` takes the lean shared-memory
  layout (the walk over the planes) at every shape; ``phase_cycles`` adds ``clock64()`` counters around
  the copy in (with the decode and the walk table), the reads of the
  decoded rows, their application without the ancestor walk, the walk,
  the write-back and the digest, summed over all warps, with the slowest
  document's total;
- three builds of the map source that split its time (``MAP_VARIANTS``:
  the memset alone, without the key pass, without the atomics).

The inputs are ``chip_smoke.py``'s: the tree kernel's pinned chunk (the
first 1,024 documents the tree workload dispatches, 48 edits each,
N = 256, C = 128, T = 64) and the map phase's batch (10,240 x
``gen_map_doc(i, 96)``).  ``--tree-wide N C`` also times the same chunk
with its planes padded to N node rows and C container rows, as the packer
pads a chunk to its widest document's buckets (each build in its own
placement there).  Every build that folds must give the kernel's result
bit for bit (both tree builds, fold and fold + digest, at every shape;
every output of the map reduction).  Then each kernel and its baseline
are timed in turns (A B B A), two ways, both with CUDA events and each a
median over its launches:

- ``device_ms``: each launch behind a ~1 ms device spin, so the events
  bound the kernel alone and not the host's time to enqueue it;
- ``call_ms``: no spin, so the host's time in the wrapper and the C entry
  counts wherever the device waits for it.

It prints one JSON line: the card, the times, the compiler's register
report and the phase split of the tree kernel.
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


def sources(args) -> dict:
    """Build name -> (kind, CUDA source), in timing order."""
    def read(path):
        with open(path) as f:
            return f.read()

    tree = read(os.path.join(CSRC, "tree_fold.cu"))
    out = {"tree": ("tree", tree), "tree_baseline": ("tree", read(
        args.tree_baseline or os.path.join(CSRC, "tree_fold_earlier.cu")))}
    for variant, edits in TREE_VARIANTS.items():
        made = _apply(tree, edits)
        if made is None:
            raise RuntimeError(f"the {variant} edits do not apply to "
                               f"csrc/tree_fold.cu")
        out[f"tree_{variant}"] = ("tree", made)
    out["map"] = ("map", read(os.path.join(CSRC, "map_lww.cu")))
    out["map_baseline"] = ("map", read(
        args.map_baseline or os.path.join(CSRC, "map_lww_earlier.cu")))
    for variant, edits in MAP_VARIANTS.items():
        made = _apply(out["map"][1], edits)
        if made is None:
            raise RuntimeError(f"the {variant} edits do not apply to "
                               f"csrc/map_lww.cu")
        out[f"map_{variant}"] = ("map", made)
    return out


def build_all(texts: dict, out_dir: str) -> dict:
    """Compile every source with the kernels' nvcc flags, all at once;
    returns name -> (bound library, ptxas lines)."""
    from fluidframework_tpu_torch.ops import (_cuda_build, map_lww_cuda,
                                              tree_fold_cuda)

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (_kind, text) in texts.items():
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
        bind = tree_fold_cuda.bind if texts[name][0] == "tree" \
            else map_lww_cuda.bind
        built[name] = (bind(lib), [ln.strip() for ln in log.splitlines()
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree-baseline", help="another source with the C "
                    "entry of csrc/tree_fold.cu (default: its earlier "
                    "design, csrc/tree_fold_earlier.cu)")
    ap.add_argument("--map-baseline", help="another source with the C "
                    "entry of csrc/map_lww.cu (default: its earlier "
                    "design, csrc/map_lww_earlier.cu)")
    ap.add_argument("--tree-wide", nargs=2, type=int, action="append",
                    metavar=("N", "C"), help="also time the pinned chunk "
                    "padded to N node rows and C container rows")
    ap.add_argument("--reps", type=int, default=7,
                    help="timed launches per build, per turn and method")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from fluidframework_tpu_torch.convert import tensors_to
    from fluidframework_tpu_torch.ops import map_kernel as mp
    from fluidframework_tpu_torch.ops import map_lww_cuda, tree_fold_cuda
    from fluidframework_tpu_torch.ops.native_pack import BUILD_DIR
    from fluidframework_tpu_torch.testing import config_workloads as cw

    dev = torch.device("cuda")
    texts = sources(args)
    built = build_all(texts, os.path.join(BUILD_DIR, "kernel_turns"))
    libs = {name: lib for name, (lib, _) in built.items()}
    libs["tree_baseline"] = tree_fold_cuda.EarlierLaunch(
        libs["tree_baseline"])
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
    parity = {}
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
    if not all(parity.values()):
        raise AssertionError(f"builds disagree with the kernel: {parity}")

    calls = {}
    for shape in shapes:
        at = "" if shape == "pinned" else f"@{shape}"
        for name in tree_names:
            if name.endswith("phase_cycles") or (
                    at and name.endswith("copy_only")):
                continue
            calls[f"{name}{at}"] = tree_call(name, False, shape)
            calls[f"{name}_digest{at}"] = tree_call(name, True, shape)
    for name in map_names:
        calls[name] = (lambda lib: lambda: map_lww_cuda.lww(
            inputs, batch.num_docs, lib=lib))(libs[name])
    runs = in_turns(calls, args.reps)

    phases = {}
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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "kernel_turns": True, "card": card,
        "tree_shapes": {k: [*v[0].next.shape, v[0].head.shape[1],
                            v[1].kind.shape[1]] for k, v in shapes.items()},
        "tree_placement": {k: tree_fold_cuda.placement(
            v[0].next.shape[1], v[0].head.shape[1])
            for k, v in shapes.items()},
        "map_shape": {"N": inputs.key_gid.shape[0], "G": batch.num_keys,
                      "M": inputs.clear_doc.shape[0]},
        "parity": parity, "order": list(calls) + list(calls)[::-1],
        "median_ms": medians(runs), "runs_ms": runs,
        "ptxas": {n: regs for n, (_, regs) in built.items()},
        "phases": phases,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
