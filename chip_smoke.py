#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (built for an H100, sm_90a).

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports
only the port (``fluidframework_tpu_torch``), torch and numpy, builds the
port's libraries from the sources in the checkout, and runs in order:

0. card and build — the card's name and power limit, then the C++ packer
   (g++) and the four kernel sources (nvcc) built side by side, with the
   compiler's register/spill report and the launch each build of the
   kernel takes (blocks and documents per SM) at the pinned, long-tail
   and large shapes;
1. kernel vs plain, hard semantics — the committed fixture folded by the
   state-out kernel and by the plain PyTorch fold on the card: every slot
   of every plane, ``n`` and ``overflow`` bit-equal, and the int32
   exports byte-identical;
2. main path of the first slice — ``replay_mergetree_batch`` over the
   pinned workload (10,240 docs x 96 ops, one batch), its launches read
   around it, a 256-document sample byte-identical to the CPU oracle; the
   same batch staged by hand; then the state path (``fold_cuda.fold``,
   the entry later warm tiers call) over the batch, against the plain
   fold;
3. long tail — 32 documents of 1,536 ops (S = 3,072 slots, the largest
   that fits shared memory), kernel vs plain and the kernel's time;
4. large S (the device-memory placement) — a full wave of cold
   documents of 2,000 ops (S = 4,096; as many as the build keeps resident
   on the card, 8 a SM on an H100): the state path against the plain fold
   (max |err| 0 over every slot, ``n`` and ``overflow``), the first 8
   alone (one a SM) against the wave's result and timed, then
   ``pipelined_mergetree_replay`` over the wave (chunks of 1,024) against
   ``replay_mergetree_batch`` and the oracle;
5. layouts — the fold+export build against the plain decode → fold →
   export → digest on the card, leaf by leaf (dtype, shape, bytes), for
   the fixture (warm), the main batch and cold copies of the fixture's
   obliterate documents (cold and warm), in every layout the chunk's
   facts allow, digest on and off: one line per combination;
6. the pipelined path at full width — ``pipelined_mergetree_replay`` over
   the pinned workload with the reference's defaults: all summaries equal
   ``replay_mergetree_batch``'s, the oracle sample identical, the stage
   dict, and ``h2d_bytes`` / ``d2h_bytes`` equal to the values worked out
   from ``export_layout_rows`` and the narrow dtypes; then the pipelined
   and the one-batch rates timed in turns (P B B P);
7. the warm catch-up path at full width (``warm_phase``, after the
   reference's ``run_delta_download_bench``): the pinned streams as
   tokened message lists, a cold fill of 80-op windows with the three
   cache tiers on, an exact warm re-run (no pack bytes up, only the digest
   plane down), every 8th document grown to 96 ops with the tiers on and
   off, and the pinned resident-state tier below its working set (spill,
   then restore); every pass equal to the one batch of the same windows;
   the resident kernels (``csrc/resident.cu``: the in-place splice and the
   narrow-to-wide migration) held against their plain versions on the
   phase's own resident buffers and timed;
8. SharedTree catch-up at full width (``tree_phase``, after the
   reference's ``run_tree_rebase``): the pinned tree workload (10,240
   documents x 48 edits, five shapes) through ``pipelined_tree_replay``
   cold, exact and grown with the three cache tiers on, the same windows
   with them off, and ``replay_tree_batch``: every pass equal to its twin,
   an oracle sample of every shape byte-identical, the byte counters and
   per-reason fallback counts equal to the JAX package's for the same
   workload, the exact pass moving nothing up and the digest plane down,
   the splice on the grown pass, the resident entries equal to the
   grown chunks' planes, and the splice held against its plain version
   along the tree's three row axes; both builds of the tree kernel
   (``csrc/tree_fold.cu``: state out, and with the fused digest) held
   against the plain fold and digest on a pinned chunk, padding rows
   included, and timed;
9. SharedMap catch-up at full width (``map_phase``, BASELINE.json config
   #2): ``replay_map_batch`` over 10,240 x ``gen_map_doc(i, 96)``, one
   launch of the LWW kernel (``csrc/map_lww.cu``), every summary equal to
   the oracle's, the stage split and the rate; the kernel held against
   its plain version and the library chain on every key entry (the main
   batch, the fixture, the crafted empty-segment cases) and timed;
10. SharedMatrix catch-up at full width (``matrix_phase``, config #4):
   ``replay_matrix_batch`` over 10,240 x ``gen_matrix_doc(i, 64)``, one
   launch of the fold's resolving build in shared memory, every summary
   equal to the oracle's, the stage split and the rate; the fixture's
   routing counts equal to the JAX package's; the resolving build held
   against the plain fold (every plane and resolved handle) on the main
   batch, the fixture, the crafted resolve cases and 16 documents of
   2,048 ops, which the entry folds in device memory; both builds timed;
11. times — each build of the fold kernel alone (CUDA events behind a
   device spin, median of 7; and the whole call), its plain version once,
   its bound, and the ``kernels`` line (the four fold builds, the two
   resident kernels, the two tree builds, the two resolving builds and
   the map kernel).

Each driven path (the one-batch entry, the state path, the large-S
paths, the pipeline, each warm pass, each tree pass, the map and matrix
entries) runs with every
launch count set to 0 just before it and read just after.  One JSON object per phase goes to stdout.  Any
failure raises (non-zero exit, no result line).  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or outside a checkout, it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
#: the pinned workload (bench.py: BENCH_DOCS x BENCH_OPS)
N_DOCS, N_OPS, ORACLE_SAMPLE = 10240, 96, 256
PINNED_S = 192  # the slots the pinned workload packs to
#: the long-tail batch: documents whose state needs S = 3,072 slots
TAIL_DOCS, TAIL_OPS, TAIL_S = 32, 1536, 3072
#: the large-S documents: cold, past a block's shared memory; the phase
#: folds a full wave of them, and the first LARGE_DOCS alone
LARGE_DOCS, LARGE_OPS, LARGE_S = 8, 2000, 4096
#: the reference's pipeline defaults, and the timed turns (P = pipelined,
#: B = one batch)
CHUNK_DOCS = 1024
TURNS = "PBBP"
DEVICE = "cuda"
KERNEL_SOURCE = "fluidframework_tpu_torch/csrc/mergetree_fold.cu"
TPU_KERNEL = "fluidframework_tpu/ops/pallas_fold.py:419"
#: the warm phase (bench.py run_delta_download_bench): cold windows of
#: 5/6 of the pinned ops, every GROW_EVERY-th document grown to all of them
WARM_BASE_OPS, GROW_EVERY = N_OPS * 5 // 6, 8
RESIDENT_SOURCE = "fluidframework_tpu_torch/csrc/resident.cu"
#: the reference's XLA-traced device code the resident kernels replace
SPLICE_REPLACES = "fluidframework_tpu/ops/device_cache.py:126"
WIDEN_REPLACES = "fluidframework_tpu/ops/device_cache.py:229"
#: the tree phase (the reference's ``run_tree_rebase``,
#: tools/bench_kernels.py): the pinned SharedTree workload, cold, exact and
#: grown with the cache tiers on, the same windows with them off
TREE_DOCS, TREE_EDITS = 10240, 48
TREE_SOURCE = "fluidframework_tpu_torch/csrc/tree_fold.cu"
TREE_REPLACES = "fluidframework_tpu/ops/tree_kernel.py:137"
TREE_DIGEST_REPLACES = ("fluidframework_tpu/ops/tree_kernel.py:137 + "
                        "fluidframework_tpu/ops/tree_pipeline.py:109")
#: the JAX package's counters for the same workload and passes, from a CPU
#: run: its byte counters depend on the layout alone and its per-reason
#: fallback counts on the semantics alone, so the port must equal them
TREE_REFERENCE = "BENCH_kernels_cpu_r14.json"
#: the oracle sample of the tree phase: every shape (``tree_shape`` keys
#: on idx % 32), then every 40th document
TREE_ORACLE_HEAD, TREE_ORACLE_EVERY = 32, 40
#: the map phase (BASELINE.json config #2, tools/bench_configs.py
#: ``gen_map_doc``) and the matrix phase (config #4, ``gen_matrix_doc``),
#: at full width; the matrix's device-memory batch (S = 4,096, past a
#: block's shared memory)
MAP_DOCS, MAP_OPS = 10240, 96
MATRIX_DOCS, MATRIX_OPS = 10240, 64
MATRIX_GMEM_DOCS, MATRIX_GMEM_OPS = 16, 2048
MAP_SOURCE = "fluidframework_tpu_torch/csrc/map_lww.cu"
MAP_REPLACES = "fluidframework_tpu/ops/map_kernel.py:140"
MATRIX_REPLACES = ("fluidframework_tpu/ops/matrix_kernel.py:70 "
                   "(+ _resolve_handle :58)")
#: the entry points' rates are the median of this many calls (the driven
#: call and the ones after it)
ENTRY_CALLS = 3
#: the JAX package's routing counts on the committed matrix fixture
#: (tests/test_torch_matrix_kernel.py holds the port's equal to them on
#: the CPU): one pre-pack fallback (two overlap removers in a base), one
#: post-fold overflow (a third remover)
MATRIX_FIXTURE_STATS = {"device_docs": 14, "fallback_docs": 2}
#: Integer operations the tree fold needs, charged per unit of its work
#: on these inputs (``tree_fold_work``): a state word in and out (a load
#: and a store each way); an edit row (decode, expiry tests, a splice's
#: reads and writes); an ancestor-walk step (two dependent reads, the
#: compares and selects); per used row and digest plane, the two lanes'
#: xor, multiply, add and weight mix.
TREE_WORD_OPS, TREE_ROW_OPS, TREE_WALK_STEP_OPS, TREE_DIGEST_OPS = \
    2, 24, 8, 18
#: H100 SXM device memory rate (bytes/s), NVIDIA data sheet
HBM_BYTES_PER_S = 3.35e12
#: int32 ALU rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost (Hopper
#: architecture white paper; the data sheet lists float rates only)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: Integer operations the fold itself needs on these inputs, charged only
#: where they need them (see ``fold_work``): per live slot of an op row,
#: the visible-length test (~15) and one scan add; one write per state
#: word the row moves (the slots from its first split or insert index on,
#: every plane); per insert row, the tie-break and obliterate-on-arrival
#: decision; per slot a range op stamps, its remove / annotate (per props
#: key) / obliterate tail.  They count the fold's work, not the work of
#: the kernel that implements it, so every version of the kernel is held
#: to the same bound.
VIEW_SCAN_OPS_PER_SLOT = 16
INSERT_ROW_OPS = 40
RANGE_OPS_PER_SLOT = {2: 8, 4: 18}  # remove, obliterate
ANNOTATE_OPS_PER_SLOT_PER_KEY = 2
#: device clock cycles spun before each timed launch (~1 ms at 1.98 GHz)
SPIN_CYCLES = 2_000_000

_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line also carries the seconds since the
    script started (``elapsed_s``)."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - _T0)
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def build_all():
    """g++ for the packer and nvcc for each kernel source, started
    together."""
    from fluidframework_tpu_torch.ops import _cuda_build, native_pack

    results, errors = {}, {}

    def run(name, fn):
        t = time.perf_counter()
        try:
            results[name] = (fn(), time.perf_counter() - t)
        except BaseException as e:  # re-raised below, on the main thread
            errors[name] = e

    jobs = [threading.Thread(target=run, args=(
                "oppack", native_pack._build_library)),
            threading.Thread(target=run, args=(
                "mergetree_fold", lambda: _cuda_build.build(
                    "mergetree_fold"))),
            threading.Thread(target=run, args=(
                "resident", lambda: _cuda_build.build("resident"))),
            threading.Thread(target=run, args=(
                "tree_fold", lambda: _cuda_build.build("tree_fold"))),
            threading.Thread(target=run, args=(
                "map_lww", lambda: _cuda_build.build("map_lww")))]
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    if errors:
        raise RuntimeError(f"build failed: {errors}")
    if results["oppack"][0] is None:
        raise RuntimeError("liboppack did not build (g++)")
    return results


def state_diff(want, got):
    """Largest |difference| over every slot of every plane (dead slots
    too), ``n`` and ``overflow`` (0 means bit-equal), and where the two
    first differ: (field, index, want, got), or None."""
    err, first = 0, None
    for f in want._fields:
        x, y = getattr(want, f).long(), getattr(got, f).long()
        d = (x - y).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
        bad = d.nonzero()
        if first is None and len(bad):
            i = tuple(bad[0].tolist())
            first = f, i, int(x[i]), int(y[i])
    return err, first


def kernel_vs_plain(state, ops):
    """Fold once with the kernel and once with the plain fold, both on the
    card; returns (max_abs_err, plain_ms, kernel_final)."""
    import torch

    from fluidframework_tpu_torch.ops import fold_cuda
    from fluidframework_tpu_torch.ops import mergetree_kernel as mt

    got = fold_cuda.fold(state, ops)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = mt.fold_reference(state, ops)
    end.record()
    torch.cuda.synchronize()
    err, first = state_diff(want, got)
    err = max(err, leaves_diff(mt.export_state(want), mt.export_state(got)))
    if err:
        print(f"kernel vs plain: first mismatch (field, index, plain, "
              f"kernel) = {first}", file=sys.stderr)
    return err, start.elapsed_time(end), got


def time_call(fn, reps=7, spin=True):
    """A launch's device time: median of ``reps`` calls of ``fn``, each
    timed with CUDA events behind a short device-side spin, so the events
    bound the kernel and not the host's time to enqueue it (the wrapper's
    checks and allocations).  ``spin=False`` times the whole call, the
    host's enqueue included wherever the device waits for it."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def timed_once(fn):
    """(result, ms) of one call, timed with CUDA events."""
    import torch

    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def leaves_diff(want, got):
    """Largest |difference| over the leaves of two exports (a tensor or a
    tuple of tensors); 0 only when every leaf has the same dtype, shape
    and bytes.  A leaf count, dtype or shape that differs raises."""
    import torch

    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    if len(want) != len(got):
        raise AssertionError(f"exports differ in leaves: {len(want)} vs "
                             f"{len(got)}")
    err = 0
    for w, g in zip(want, got):
        if (w.dtype, w.shape) != (g.dtype, g.shape):
            raise AssertionError(f"exports differ in layout: {w.dtype} "
                                 f"{tuple(w.shape)} vs {g.dtype} "
                                 f"{tuple(g.shape)}")
        if not torch.equal(w, g):
            err = max(err, 1, int((w.long() - g.long()).abs().max()))
    return err


class PlainExport:
    """The plain decode → fold → export → digest on the card, with the
    decoded fold run once per input encoding (the export and digest are
    then taken per layout)."""

    def __init__(self, S, doc_base):
        self.S, self.base, self._finals = S, doc_base, {}

    def final(self, state, ops):
        from fluidframework_tpu_torch.ops import mergetree_kernel as mt

        key = (ops.seq.dtype, None if state is None else state.n.dtype)
        if key not in self._finals:
            wide = mt._widen_ops(ops, self.base)
            start = mt.cold_start(wide, self.S) if state is None \
                else mt._widen_state(state, self.base)
            self._finals[key] = mt.fold_reference(start, wide)
        return self._finals[key]

    def __call__(self, state, ops, layout, digest):
        from fluidframework_tpu_torch.ops import mergetree_kernel as mt

        return mt.export_final(self.final(state, ops), self.base, layout,
                               digest)


def nbytes(tree):
    """Bytes of the tensors or arrays in a tree (None counts 0)."""
    if tree is None:
        return 0
    leaves = tree if isinstance(tree, tuple) else (tree,)
    return int(sum(x.numel() * x.element_size() if hasattr(x, "numel")
                   else x.nbytes for x in leaves if x is not None))


def expected_transfer(packed):
    """(h2d, d2h) bytes of a pipelined run worked out from each chunk's
    layout facts (cold chunks): the op stream in the narrow dtypes when
    ``i16_ok`` holds (else int32), and the transfer buffer
    of ``export_layout_rows`` rows (int16 when ``i16_ok``, plus the
    [D, 4] int32 misc leaf for i8 layouts)."""
    import numpy as np

    from fluidframework_tpu_torch.ops import mergetree_kernel as mt

    h2d = d2h = 0
    for state, ops, meta, S in packed:
        if state is not None:
            raise AssertionError("expected_transfer counts cold chunks")
        D, T = ops.kind.shape
        K = meta["props_K"]
        i16, _ob, _ov, i8, _props = mt._export_flags(meta)
        size = {f: np.dtype(mt._UPLOAD_NARROW_DTYPES[f]).itemsize if i16
                else 4 for f in mt.MTOps._fields}
        h2d += D * T * (sum(size[f] for f in mt.OP_FIELDS)
                        + K * size["pvals"])
        d2h += D * mt.export_layout_rows(meta) * S * (2 if i16 else 4)
        d2h += D * 4 * 4 if i8 else 0
    return h2d, d2h


_FOLD_WORK = {}


def fold_work(state, ops):
    """``fold_work_of`` once per pair of input tensors (a state-out and a
    fold+export bound of the same batch share the walk).  The cache holds
    the tensors it keys on, so no other tensor can take their address."""
    key = tuple((x.data_ptr(), tuple(x.shape))
                for x in (state.tstart, ops.kind))
    if key not in _FOLD_WORK:
        _FOLD_WORK[key] = (fold_work_of(state, ops), state.tstart, ops.kind)
    return _FOLD_WORK[key][0]


def fold_work_of(state, ops):
    """Integer operations the fold needs on these inputs, found by walking
    the op tail with the plain fold's own steps: for each real op row, one
    view and scan over the slots live at that row, the shift of the slots
    after each split or insert index only, the insert's own slot and
    decision, and the range tail over the slots the op stamps; for each
    matrix resolve row (kind 5), one view and scan over the live slots."""
    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mt
    from fluidframework_tpu_torch.ops.matrix_kernel import K_RESOLVE

    st = mt._stack_state(state)
    D, P, S = st.shape
    K = P - len(mt.EXPORT_SLOT_FIELDS)
    n = state.n.to(torch.int32).reshape(D, 1)
    overflow = state.overflow.to(torch.bool).reshape(D, 1)
    slot = torch.arange(S, device=st.device)[None, :]
    fields = {f: getattr(ops, f).to(torch.int32) for f in mt.OP_FIELDS}
    tail = torch.zeros(5, dtype=torch.int64, device=st.device)
    tail[mt.K_REMOVE] = RANGE_OPS_PER_SLOT[mt.K_REMOVE]
    tail[mt.K_OBLITERATE] = RANGE_OPS_PER_SLOT[mt.K_OBLITERATE]
    tail[mt.K_ANNOTATE] = ANNOTATE_OPS_PER_SLOT_PER_KEY * K
    total = torch.zeros((), dtype=torch.int64, device=st.device)
    live_slots = torch.zeros_like(total)
    for t in range(ops.kind.shape[1]):
        op = {f: x[:, t:t + 1] for f, x in fields.items()}
        op["pvals"] = ops.pvals[:, t].to(torch.int32)
        kind, ref, client = op["kind"], op["ref_seq"], op["client"]
        a, b = op["a"], op["b"]
        real = (kind >= mt.K_INSERT) & (kind <= mt.K_OBLITERATE)
        is_ins = kind == mt.K_INSERT
        # The boundary splits as the fold makes them.  lo is the first
        # slot the row's shifts write: a split writes its right half at
        # idx + 1, an insert its own slot at j; every slot from lo on is
        # written once, by the row's combined shift.
        s, m = st, n
        lo = torch.full_like(n, S)
        for pos, on in ((a, real), (b, real & ~is_ins)):
            v = mt._visible_len(s, m, slot, ref, client)
            cum = mt._excl_cumsum(v)
            idx = mt._first((cum < pos) & (pos < cum + v), slot, S)
            lo = torch.where(on & (idx < S), torch.minimum(lo, idx + 1), lo)
            s, m = mt._split_at(s, m, slot, pos, ref, client, on)
        v = mt._visible_len(s, m, slot, ref, client)
        cum = mt._excl_cumsum(v)
        active = slot < m
        j = mt._first((cum >= a) & active, slot, S)
        j = torch.where(j < S, j, m)
        lo = torch.where(is_ins, torch.minimum(lo, j), lo)
        moved = torch.where(lo < S, m + is_ins.int() - lo, 0)
        stamped = ((cum >= a) & (cum + v <= b) & (v > 0) & active) | (
            (kind == mt.K_OBLITERATE) & active & (v == 0) & (cum > a)
            & (cum < b))
        row = (m.long() * VIEW_SCAN_OPS_PER_SLOT + moved.long() * P
               + is_ins.long() * INSERT_ROW_OPS
               + stamped.sum(1, keepdim=True) * tail[kind.long().clamp(0, 4)])
        total += torch.where(real, row, 0).sum()
        total += torch.where(kind == K_RESOLVE,
                             n.clamp(max=S).long() * VIEW_SCAN_OPS_PER_SLOT,
                             0).sum()
        live_slots += torch.where(real, m, 0).sum()
        st, n, overflow = mt._apply_op(st, n, overflow, slot, op)
    return int(total), int(live_slots)


def bound_ms(state, ops, moved, extra_ops=0):
    """Least time for the fold at these inputs: the larger of the bytes it
    must move (``moved``: each input read once, each output written once)
    over HBM and the integer work these inputs need (``fold_work``, plus
    ``extra_ops``) over the int32 rate."""
    kind = ops.kind
    real_rows = int(((kind >= 1) & (kind <= 4)).sum())
    int_ops, live_slots = fold_work(state, ops)
    int_ops += extra_ops
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = int_ops / INT32_OPS_PER_S * 1e3
    return {
        "bytes": moved, "int_ops": int_ops, "bytes_ms": bytes_ms,
        "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "real_op_rows": real_rows,
        "mean_live_slots": live_slots / max(1, real_rows),
    }


def state_out_bytes(D, S, T, K):
    """State in + state out + the int32 op stream once."""
    state_bytes = D * ((12 + K) * S * 4 + 4 + 1)
    return 2 * state_bytes + D * T * (9 + K) * 4


def reset_counts():
    from fluidframework_tpu_torch.ops import (fold_cuda, map_lww_cuda,
                                              resident_cuda, tree_fold_cuda)

    fold_cuda.reset_launches()
    resident_cuda.reset_launches()
    tree_fold_cuda.reset_launches()
    map_lww_cuda.reset_launches()


def read_counts():
    """Launches of each build of the fold kernel, of each resident kernel,
    of each build of the tree kernel and of the map kernel since
    ``reset_counts``."""
    from fluidframework_tpu_torch.ops import (fold_cuda, map_lww_cuda,
                                              resident_cuda, tree_fold_cuda)

    counts = {f"{entry.__name__}_{where}": n
              for entry in (fold_cuda.fold, fold_cuda.fold_export,
                            fold_cuda.fold_resolving)
              for where, n in entry.placements.items()}
    counts["map_lww"] = map_lww_cuda.lww.launches
    counts["splice_rows"] = resident_cuda.splice_rows.launches
    counts["widen_resident"] = resident_cuda.widen_resident.launches
    counts.update({f"tree_{entry.__name__}_{where}": n
                   for entry in (tree_fold_cuda.fold,
                                 tree_fold_cuda.fold_digest)
                   for where, n in entry.placements.items()})
    return counts


def bytes_bound(moved, elements):
    """Least time for a kernel that moves ``moved`` bytes and does about
    one integer operation an element: the larger of the two over the
    card's rates."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = elements / INT32_OPS_PER_S * 1e3
    return {"bytes": moved, "int_ops": elements, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def tree_diff(want, got):
    """Largest |difference| over the planes of two namedtuples of tensors
    (0 only when every plane has the same dtype, shape and bytes)."""
    return max(leaves_diff(getattr(want, f), getattr(got, f))
               for f in type(want)._fields)


def warm_phase(dev, docs, sample, drive, launches):
    """Phase 7: the warm catch-up path at full width, as the reference's
    ``run_delta_download_bench`` (bench.py) drives it.  The pinned
    workload's streams as message lists under stable cache tokens: a cold
    fill of 5/6-length windows with every tier on, a second pack cache
    filled for the tiers-off runs, an exact warm re-run, every 8th
    document grown to the full stream (same T bucket, so the splice route
    applies) with the tiers on and off, then the pinned resident-state
    tier below its working set (spill) and again (restore).  Every pass
    equals ``replay_mergetree_batch`` of the same windows (which equals
    the CPU oracle on a sample); the resident kernels are held against
    their plain versions on the phase's own resident buffers.  Returns the
    two resident kernels' rows of the ``kernels`` line."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.convert import tensors_to
    from fluidframework_tpu_torch.ops import mergetree_kernel as mt
    from fluidframework_tpu_torch.ops import resident_cuda
    from fluidframework_tpu_torch.ops.device_cache import (
        DevicePackCache, gather_suffix_rows)
    from fluidframework_tpu_torch.ops.pipeline import (
        PackCache, pipelined_mergetree_replay)
    from fluidframework_tpu_torch.service.catchup_cache import (
        DeltaExportCache)
    from fluidframework_tpu_torch.testing import workload

    def digests(summaries):
        return [x.digest() for x in summaries]

    t = time.perf_counter()
    streams = [workload.doc_ops(d) for d in docs]
    decode_s = time.perf_counter() - t
    grown_idx = set(range(0, len(docs), GROW_EVERY))

    def window(i, n):
        msgs = streams[i][:n]
        return mt.MergeTreeDocInput(
            doc_id=f"ddoc{i}", ops=msgs, final_seq=msgs[-1].seq,
            final_msn=0, cache_token=("bench-epoch", f"ddoc{i}", 0, ""))

    windows = {
        "base": [window(i, WARM_BASE_OPS) for i in range(len(docs))],
        "grown": [window(i, N_OPS if i in grown_idx else WARM_BASE_OPS)
                  for i in range(len(docs))]}
    want, refs = {}, {}
    for label, ds in windows.items():
        t = time.perf_counter()
        want[label] = digests(mt.replay_mergetree_batch(ds, device=dev))
        batch_s = time.perf_counter() - t
        bad = [i for i in sample if want[label][i]
               != workload.oracle_replay(ds[i]).summarize().digest()]
        refs[label] = {"batch_s": batch_s, "oracle_mismatches": bad}
        if bad:
            raise AssertionError(f"warm {label} windows: one batch differs "
                                 f"from the oracle at {bad[:8]}")

    pack, delta = PackCache(), DeltaExportCache()
    resident = DevicePackCache(device=dev)
    on = {"pack_cache": pack, "delta_cache": delta,
          "device_cache": resident}
    off = {"pack_cache": PackCache()}
    passes = {}

    def one_pass(name, label, tiers, pin=False):
        stage, stats, packed = {}, {}, []
        got, wall = drive(f"warm_{name}", lambda: pipelined_mergetree_replay(
            windows[label], chunk_docs=CHUNK_DOCS, stats=stats, stage=stage,
            packed_out=packed, pin_resident=pin, device=dev, **tiers))
        rec = {"windows": label, "wall_s": wall,
               "busy_s": {k: v for k, v in stage.items()
                          if not k.endswith("_bytes")},
               "h2d_bytes": stage["h2d_bytes"],
               "d2h_bytes": stage["d2h_bytes"],
               "delta_docs": stats.get("delta_docs", 0), "stats": stats,
               "launches": launches[f"warm_{name}"],
               "tiers": {k: v.stats() for k, v in tiers.items()},
               "equals_batch": digests(got) == want[label]}
        emit({"phase": "warm_pass", "pass": name, **rec})
        if not rec["equals_batch"]:
            raise AssertionError(f"warm pass {name}: summaries differ from "
                                 f"the one batch of the same windows")
        passes[name] = rec
        return packed

    def entry_of(meta):
        return resident._entries[tuple(d.cache_token for d in meta["docs"])]

    # 1-2. cold fill with every tier on; the tiers-off pack cache filled
    cold_packed = one_pass("cold", "base", on)
    one_pass("fill_off", "base", off)

    # 3. exact warm re-run: the folds read the resident buffers, which must
    # keep their bytes (the fold+export build never writes its inputs)
    entries = [entry_of(m) for _s, _o, m, _t in cold_packed]
    before = [[x.clone() for x in tuple(e.ops) + (e.base,)] for e in entries]
    one_pass("exact", "base", on)
    unchanged = all(torch.equal(a, b) for e, snap in zip(entries, before)
                    for a, b in zip(tuple(e.ops) + (e.base,), snap))
    if not unchanged:
        raise AssertionError("a fold wrote a resident buffer it read")
    exact = passes["exact"]
    if exact["h2d_bytes"] != 0 or exact["d2h_bytes"] != 8 * len(docs):
        raise AssertionError(f"exact warm re-run moved h2d "
                             f"{exact['h2d_bytes']} / d2h "
                             f"{exact['d2h_bytes']} B; want 0 / "
                             f"{8 * len(docs)}")

    # widen_resident on the resident narrow buffers, against the plain
    # decode (new tensors: the entries are not touched)
    cold_dtype = str(entries[0].ops.seq.dtype)
    widen_err = 0
    for e, (_s, host_ops, meta, _t) in zip(entries, cold_packed):
        narrow = e.ops if mt.upload_encoding(e.ops) else tensors_to(
            mt.narrow_ops_for_upload(host_ops, meta), dev)
        if not mt.upload_encoding(narrow):
            raise AssertionError("the cold chunk did not narrow")
        widen_err = max(widen_err, tree_diff(
            mt._widen_ops(narrow, e.base),
            resident_cuda.widen_resident(narrow, e.base)))
    if widen_err:
        raise AssertionError(f"widen_resident != plain: {widen_err}")
    w_ops, w_base = entries[0].ops, entries[0].base
    w_ms, w_runs = time_call(
        lambda: resident_cuda.widen_resident(w_ops, w_base))
    _out, w_plain_ms = timed_once(lambda: mt._widen_ops(w_ops, w_base))
    w_numel = sum(x.numel() for x in w_ops)
    w_bound = bytes_bound(nbytes(tuple(w_ops)) + nbytes(w_base)
                          + 4 * w_numel, w_numel)

    # 4. grown warm run with the tiers on: suffix splices (and, where the
    # suffix text pushed the chunk past the int16 bound, the migration)
    grown_packed = one_pass("grown", "grown", on)
    grown_entries = [entry_of(m) for _s, _o, m, _t in grown_packed]
    migrated = sum(1 for e in grown_entries
                   if e.ops.seq.dtype == torch.int32)
    mirror_err = max(tree_diff(mt.MTOps(*(torch.from_numpy(
        np.ascontiguousarray(x)).to(dev) for x in host_ops)), e.ops)
        for e, (_s, host_ops, _m, _t) in zip(grown_entries, grown_packed))
    if mirror_err:
        raise AssertionError(f"resident ops differ from the grown chunk's "
                             f"host arrays: {mirror_err}")
    # splice_rows on the resident buffers: the suffix rows spliced again,
    # by the kernel and by the plain version, into copies whose every
    # element from each document's t_old on is bit-flipped first.  The
    # splice must restore exactly the rows [t_old, t_new) (a missed
    # element stays flipped) and write nothing from t_new on (pad rows
    # there would overwrite the flipped values).
    def flipped_from(ops, first):
        cut = torch.arange(ops.kind.shape[1], device=dev)[None, :] \
            >= first[:, None]
        return mt.MTOps(*(torch.where(cut if x.ndim == 2 else cut[..., None],
                                      ~x, x) for x in ops))

    splice_err, splice_case = 0, None
    for e, (_s, host_ops, _m, _t), (_s0, cold_ops, _m0, _t0) in zip(
            grown_entries, grown_packed, cold_packed):
        t_old = np.count_nonzero(np.asarray(cold_ops.kind), axis=1).astype(
            np.int32)
        t_new = np.count_nonzero(np.asarray(host_ops.kind), axis=1).astype(
            np.int32)
        rows_np, L = gather_suffix_rows(mt.MTOps, host_ops, t_old, t_new)
        rows = mt.MTOps(**{f: torch.from_numpy(v).to(dev)
                           for f, v in rows_np.items()})
        start = torch.from_numpy(t_old).to(dev)
        count = torch.from_numpy(t_new - t_old).to(dev)
        unspliced = flipped_from(e.ops, start)
        kernel = mt.MTOps(*(x.clone() for x in unspliced))
        plain = mt.MTOps(*(x.clone() for x in unspliced))
        resident_cuda.splice_rows(kernel, rows, start, count)
        resident_cuda.splice_rows_reference(plain, rows, start, count)
        splice_err = max(splice_err, tree_diff(plain, kernel), tree_diff(
            flipped_from(e.ops, torch.from_numpy(t_new).to(dev)), kernel))
        if int((t_new - t_old).sum()) and not tree_diff(unspliced, kernel):
            raise AssertionError("splice_rows wrote no row of the suffix")
        if splice_case is None:
            splice_case = (kernel, plain, rows, start, count, L,
                           int((t_new - t_old).sum()))
    if splice_err:
        raise AssertionError(f"splice_rows != plain: {splice_err}")
    kernel, plain, rows, start, count, L, n_rows = splice_case
    s_ms, s_runs = time_call(
        lambda: resident_cuda.splice_rows(kernel, rows, start, count))
    _out, s_plain_ms = timed_once(
        lambda: resident_cuda.splice_rows_reference(plain, rows, start,
                                                    count))
    row_bytes = sum(x.element_size() * (x.shape[2] if x.ndim == 3 else 1)
                    for x in kernel)
    s_bound = bytes_bound(2 * n_rows * row_bytes + nbytes((start, count)),
                          n_rows * sum(x.shape[2] if x.ndim == 3 else 1
                                       for x in kernel))

    # 5. the same grown corpus with the tiers off
    one_pass("grown_off", "grown", off)
    grown, full = passes["grown"], passes["grown_off"]
    ratios = {"h2d": full["h2d_bytes"] / max(1, grown["h2d_bytes"]),
              "d2h": full["d2h_bytes"] / max(1, grown["d2h_bytes"])}
    if not (grown["h2d_bytes"] < full["h2d_bytes"]
            and grown["d2h_bytes"] < full["d2h_bytes"]):
        raise AssertionError(f"the grown warm run moved no fewer bytes than "
                             f"the tiers-off run: {ratios}")

    # 6. the pinned resident-state tier below its working set, twice
    resident.pin_max_bytes = resident.stats()["bytes"] // 2
    one_pass("pinned", "grown", on, pin=True)
    one_pass("pinned_again", "grown", on, pin=True)
    st = resident.stats()
    if st["spills"] < 1 or st["unspills"] < 1:
        raise AssertionError(f"the pinned passes did not spill and "
                             f"restore: {st}")

    k6 = launches["warm_grown"]
    emit({"phase": "warm", "docs": len(docs), "base_ops": WARM_BASE_OPS,
          "grown_docs": len(grown_idx), "decode_s": decode_s,
          "references": refs, "resident_unchanged_by_folds": unchanged,
          "cold_entry_ops_dtype": cold_dtype,
          "migrated_entries": migrated, "entries": len(grown_entries),
          "grown_vs_off_ratio": ratios,
          "k1_launches": {k: {b: n for b, n in v.items()
                              if b.startswith("fold")}
                          for k, v in launches.items()
                          if k.startswith("warm_")},
          "k6_launches_grown": {"splice_rows": k6["splice_rows"],
                                "widen_resident": k6["widen_resident"]},
          "splice_rows": {"max_abs_err": splice_err, "shape": [
              kernel.kind.shape[0], kernel.kind.shape[1], L],
              "dtype": str(kernel.seq.dtype), "rows": n_rows, "ms": s_ms,
              "runs_ms": s_runs, "plain_ms": s_plain_ms, "bound": s_bound},
          "widen_resident": {"max_abs_err": widen_err,
                             "shape": list(w_ops.kind.shape),
                             "ms": w_ms, "runs_ms": w_runs,
                             "plain_ms": w_plain_ms, "bound": w_bound},
          "tiers": {k: v.stats() for k, v in on.items()}})
    for name in ("splice_rows", "widen_resident"):
        if k6[name] < 1:
            raise AssertionError(f"{name}: no launch on the grown warm run "
                                 f"({k6})")

    def row(name, replaces, err, ms, plain_ms, bound):
        return {"name": name, "route": "cuda", "source": RESIDENT_SOURCE,
                "replaces": replaces, "launches": k6[name],
                "path": "warm_grown", "max_abs_err": err, "tolerance": 0,
                "parity": err == 0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "library_ms": None}

    return [row("splice_rows", SPLICE_REPLACES, splice_err, s_ms,
                s_plain_ms, s_bound),
            row("widen_resident", WIDEN_REPLACES, widen_err, w_ms,
                w_plain_ms, w_bound)]


def tree_fold_work(state, edits, walk_steps, counts=None):
    """``(bytes, int_ops)`` the tree fold needs on these inputs: each
    input plane read once and each output written once (with the digest:
    the two count planes in, the ``[D, 2]`` digest out), and the
    operations of ``TREE_*_OPS`` over the state words, the real edit rows,
    the ancestor-walk steps these inputs took (``walk_steps``, counted by
    the plain fold) and, with the digest, the used rows of each plane."""
    import torch

    D, N = state.next.shape
    C = state.head.shape[1]
    state_bytes = D * (7 * N + 2 * C) * 4 + D
    moved = 2 * state_bytes + sum(x.numel() * 4 for x in edits)
    rows = int(((edits.kind >= 1) & (edits.kind <= 4)).sum())
    ops = (D * (7 * N + 2 * C) * TREE_WORD_OPS + rows * TREE_ROW_OPS
           + walk_steps * TREE_WALK_STEP_OPS)
    if counts is not None:
        n, c = counts
        moved += 2 * D * 4 + D * 8
        used = int(torch.clamp(n, 0, N).sum()) * 7 \
            + int(torch.clamp(c, 0, C).sum()) * 2
        ops += used * TREE_DIGEST_OPS
    return moved, ops, rows


def tree_splice_check(dev, cold_packed, grown_packed, resident,
                      path_splices):
    """``splice_rows`` at the tree's shapes, on the grown pass's chunks:
    first, every resident entry must hold its grown chunk's host planes
    (what the path's splices built); then, along each of the three axes
    (8 edit planes ``[D, T]``, 7 node planes ``[D, N]``, 2 container
    planes ``[D, C]``), the suffix rows past the cold chunk's counts are
    spliced by the kernel and by the plain version into copies of the
    grown planes whose every element from each document's old count on is
    bit-flipped.  Both must agree, restore exactly the rows [old, new) and
    leave the rows from new on flipped, and the cases must be as many as
    the ``path_splices`` launches the grown pass made.  Returns, per axis,
    the largest difference, the cases and rows checked, and one case
    timed."""
    import numpy as np
    import torch

    from fluidframework_tpu_torch.convert import tensors_to
    from fluidframework_tpu_torch.ops import resident_cuda
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.ops import tree_pipeline as tp
    from fluidframework_tpu_torch.ops.device_cache import gather_suffix_rows

    def tokens(meta):
        return tuple(d.cache_token for d in meta["docs"])

    def flipped_from(planes, first):
        cut = torch.arange(planes[0].shape[1], device=dev)[None, :] \
            >= first[:, None]
        return type(planes)(*(torch.where(cut, ~x, x) for x in planes))

    cold_by = {tokens(m): (o, m) for _s, o, m, _t in cold_packed}
    axes = (("edits", tk.TreeEdits), ("nodes", tp._TreeNodePlanes),
            ("containers", tp._TreeContPlanes))
    out = {axis: {"max_abs_err": 0, "cases": 0, "rows": 0}
           for axis, _g in axes}
    mirror_err, timed = 0, {}
    for host_st, host_ed, meta, _t in grown_packed:
        if tokens(meta) not in cold_by:
            raise AssertionError("a grown tree chunk has no cold twin")
        cold_ed, cold_meta = cold_by[tokens(meta)]
        e = resident._entries[tokens(meta)]
        mirror_err = max(mirror_err,
                         tree_diff(tensors_to(host_st, dev), e.state),
                         tree_diff(tensors_to(host_ed, dev), e.ops))
        counts = ((tp.TreeDeviceOps.t_rows(cold_ed),
                   tp.TreeDeviceOps.t_rows(host_ed)),
                  (cold_meta["n_nodes"], meta["n_nodes"]),
                  (cold_meta["n_cont"], meta["n_cont"]))
        for (axis, group), host, (old, new) in zip(
                axes, (host_ed, host_st, host_st), counts):
            old = np.asarray(old, np.int32)
            new = np.asarray(new, np.int32)
            rows_np, L = gather_suffix_rows(group, host, old, new)
            if not np.any(new > old) or rows_np is None:
                continue
            rows = group(**{f: torch.from_numpy(v).to(dev)
                            for f, v in rows_np.items()})
            start = torch.from_numpy(old).to(dev)
            count = torch.from_numpy(new - old).to(dev)
            full = group(*(torch.from_numpy(np.ascontiguousarray(
                getattr(host, f))).to(dev) for f in group._fields))
            unspliced = flipped_from(full, start)
            kernel = group(*(x.clone() for x in unspliced))
            plain = group(*(x.clone() for x in unspliced))
            resident_cuda.splice_rows(kernel, rows, start, count)
            resident_cuda.splice_rows_reference(plain, rows, start, count)
            n_rows = int((new - old).sum())
            if not tree_diff(unspliced, kernel):
                raise AssertionError(f"splice_rows wrote no {axis} row of "
                                     f"the suffix")
            rec = out[axis]
            restored = flipped_from(full, torch.from_numpy(new).to(dev))
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     tree_diff(plain, kernel),
                                     tree_diff(restored, kernel))
            rec["cases"] += 1
            rec["rows"] += n_rows
            rec.setdefault("shape", [*full[0].shape, L])
            timed.setdefault(axis, (kernel, plain, rows, start, count,
                                    n_rows))
    if mirror_err:
        raise AssertionError(f"resident tree entries differ from the grown "
                             f"chunks' host planes: {mirror_err}")
    cases = sum(rec["cases"] for rec in out.values())
    if cases != path_splices:
        raise AssertionError(f"{cases} tree splices checked, but the grown "
                             f"pass launched {path_splices}")
    for axis, rec in out.items():
        if not rec["cases"]:
            raise AssertionError(f"no grown tree chunk spliced {axis} rows")
        if rec["max_abs_err"]:
            raise AssertionError(f"splice_rows != plain along the tree's "
                                 f"{axis} axis: {rec['max_abs_err']}")
        kernel, plain, rows, start, count, n_rows = timed[axis]
        rec["ms"], rec["runs_ms"] = time_call(
            lambda: resident_cuda.splice_rows(kernel, rows, start, count))
        _x, rec["plain_ms"] = timed_once(
            lambda: resident_cuda.splice_rows_reference(plain, rows, start,
                                                        count))
        rec["bound"] = bytes_bound(
            2 * n_rows * 4 * len(kernel) + nbytes((start, count)),
            n_rows * len(kernel))
    return out


def tree_phase(dev, drive, launches):
    """Phase 8: SharedTree catch-up at full width, as the reference's
    ``run_tree_rebase`` (tools/bench_kernels.py) drives it: the pinned
    workload (10,240 documents x 48 edits, five shapes) through
    ``pipelined_tree_replay`` cold, exact and grown with the three cache
    tiers on, the base and grown windows with them off, and
    ``replay_tree_batch`` over the grown windows.  Gates: every pass equal
    to its twin (tiers on = off = one batch), an oracle sample
    byte-identical, the per-pass byte counters and per-reason fallback
    counts equal to the JAX package's for the same workload, the exact
    pass moving no bytes up and only the digest plane down, the splice on
    the grown pass and held against its plain version at the tree's
    shapes (``tree_splice_check``); then both builds of the tree kernel
    against the plain fold and digest on one pinned chunk, every plane
    with its padding rows, and timed.  Returns the kernels' rows of the
    ``kernels`` line and the splice's record on the tree path."""
    import torch

    from fluidframework_tpu_torch.convert import tensors_to
    from fluidframework_tpu_torch.ops import tree_fold_cuda
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.ops import tree_pipeline as tp
    from fluidframework_tpu_torch.service.catchup_cache import (
        DeltaExportCache)
    from fluidframework_tpu_torch.testing import tree_workload as tw

    with open(os.path.join(REPO, TREE_REFERENCE)) as f:
        ref = json.load(f)["tree_rebase"]
    t = time.perf_counter()
    base, grown = tw.tree_windows(TREE_DOCS, TREE_EDITS)
    synth_s = time.perf_counter() - t
    shapes = {name: sum(1 for i in range(TREE_DOCS)
                        if tw.tree_shape(i) == name) for name in tw.SHAPES}
    on = {"pack_cache": tp.tree_pack_cache(),
          "delta_cache": DeltaExportCache(),
          "device_cache": tp.tree_device_cache(device=dev)}
    passes, digests_of = {}, {}

    def one_pass(name, docs, tiers):
        stage, stats, packed = {}, {}, []
        got, wall = drive(f"tree_{name}", lambda: tp.pipelined_tree_replay(
            docs, chunk_docs=CHUNK_DOCS, stats=stats, stage=stage,
            packed_out=packed, device=dev, **tiers))
        rec = {"wall_s": wall,
               "busy_s": {k: v for k, v in stage.items()
                          if not k.endswith("_bytes")},
               "h2d_bytes": stage["h2d_bytes"],
               "d2h_bytes": stage["d2h_bytes"],
               "delta_docs": stats.get("delta_docs", 0), "stats": stats,
               "chunks": len(packed), "launches": launches[f"tree_{name}"],
               "tiers": {k: v.stats() for k, v in tiers.items()}}
        emit({"phase": "tree_pass", "pass": name, **rec})
        passes[name] = rec
        digests_of[name] = [x.digest() for x in got]
        return packed

    cold_packed = one_pass("cold", base, on)
    one_pass("exact", base, on)
    grown_packed = one_pass("grown", grown, on)
    splice = tree_splice_check(dev, cold_packed, grown_packed,
                               on["device_cache"],
                               launches["tree_grown"]["splice_rows"])
    one_pass("off_base", base, {})
    one_pass("off_grown", grown, {})
    batch, batch_s = drive("tree_batch", lambda: tk.replay_tree_batch(
        grown, device=dev))
    digests_of["batch"] = [x.digest() for x in batch]

    agree = {"cold=off_base": digests_of["cold"] == digests_of["off_base"],
             "exact=cold": digests_of["exact"] == digests_of["cold"],
             "grown=off_grown":
                 digests_of["grown"] == digests_of["off_grown"],
             "grown=batch": digests_of["grown"] == digests_of["batch"]}
    sample = list(range(TREE_ORACLE_HEAD)) + list(
        range(TREE_ORACLE_EVERY, TREE_DOCS, TREE_ORACLE_EVERY))
    t = time.perf_counter()
    bad = [(label, i) for label, docs, key in (
        ("base", base, "cold"), ("grown", grown, "grown"))
        for i in sample if digests_of[key][i]
        != tk.oracle_fallback_summary(docs[i]).digest()]
    oracle_s = time.perf_counter() - t
    # the per-pass counters against the JAX package's (the grown pass's
    # d2h is a bucketed gather on the card, exact rows on the CPU: shown)
    want = {"cold": ("cold", True), "exact": ("warm_exact", True),
            "grown": ("warm_grown", False), "off_base": ("caches_off", True)}
    counters = {}
    for name, (ref_name, with_d2h) in want.items():
        got_c = {"h2d_bytes": passes[name]["h2d_bytes"],
                 "stats": passes[name]["stats"]}
        want_c = {"h2d_bytes": ref[ref_name]["h2d_bytes"],
                  "stats": ref[ref_name]["stats"]}
        if with_d2h:
            got_c["d2h_bytes"] = passes[name]["d2h_bytes"]
            want_c["d2h_bytes"] = ref[ref_name]["d2h_bytes"]
        counters[name] = {"equal": got_c == want_c, "port": got_c,
                          "reference": want_c}
    dispatched = sum(1 for d in base if not tk.known_tree_fallback(d))
    chunks = passes["cold"]["chunks"]
    k5_path = {"tree_cold": ("tree_fold_digest_smem", chunks),
               "tree_exact": ("tree_fold_digest_smem", chunks),
               "tree_grown": ("tree_fold_digest_smem", chunks),
               "tree_off_base": ("tree_fold_smem", chunks),
               "tree_off_grown": ("tree_fold_smem", chunks),
               "tree_batch": ("tree_fold_smem", 1)}
    path_ok = {p: launches[p][k] == n for p, (k, n) in k5_path.items()}

    # K5 against its plain versions on one pinned chunk, both builds
    host_st, host_ed, meta, _tag = cold_packed[0]
    st, ed = tensors_to(host_st, dev), tensors_to(host_ed, dev)
    counts = (torch.from_numpy(meta["n_nodes"]).to(dev),
              torch.from_numpy(meta["n_cont"]).to(dev))
    work = {}
    want_final = tk.tree_fold_reference(st, ed, work)
    want_dig = tp.tree_doc_digests(want_final, *counts)
    got_final = tree_fold_cuda.fold(st, ed)
    got_final2, got_dig = tree_fold_cuda.fold_digest(st, ed, *counts)
    torch.cuda.synchronize()
    err_fold = tree_diff(want_final, got_final)
    err_digest = max(tree_diff(want_final, got_final2),
                     leaves_diff(want_dig, got_dig))
    overflowed = int(want_final.overflow.sum())
    D, N = host_st.next.shape
    C, T = host_st.head.shape[1], host_ed.kind.shape[1]
    rows = {}
    for name, build, fn, plain in (
            ("tree_fold", "tree_fold_smem",
             lambda: tree_fold_cuda.fold(st, ed),
             lambda: tk.tree_fold_reference(st, ed)),
            ("tree_fold_digest", "tree_fold_digest_smem",
             lambda: tree_fold_cuda.fold_digest(st, ed, *counts),
             lambda: tp.tree_doc_digests(tk.tree_fold_reference(st, ed),
                                         *counts))):
        ms, runs = time_call(fn)
        call_ms, _ = time_call(fn, spin=False)
        _out, plain_ms = timed_once(plain)
        moved, ops, real_rows = tree_fold_work(
            st, ed, work["walk_steps"],
            counts if name == "tree_fold_digest" else None)
        bound = bytes_bound(moved, ops)
        path = "tree_cold" if name == "tree_fold_digest" else "tree_off_base"
        rows[name] = {
            "name": name, "route": "cuda", "source": TREE_SOURCE,
            "replaces": TREE_DIGEST_REPLACES if name == "tree_fold_digest"
            else TREE_REPLACES,
            "placement": tree_fold_cuda.placement(N, C),
            "launches": launches[path][build], "path": path,
            "timed_shape": [D, N, C, T],
            "max_abs_err": err_digest if name == "tree_fold_digest"
            else err_fold, "tolerance": 0, "ms": ms, "runs_ms": runs,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "bound": bound, "real_edit_rows": real_rows,
            "walk_steps": work["walk_steps"], "library_ms": None,
            "library": "none: no one PyTorch call computes this fold"}
        rows[name]["parity"] = rows[name]["max_abs_err"] == 0

    emit({"phase": "tree", "docs": TREE_DOCS, "edits": TREE_EDITS,
          "shapes": shapes, "grown_docs": TREE_DOCS // GROW_EVERY,
          "synth_s": synth_s, "batch_s": batch_s,
          "oracle_sample": len(sample), "oracle_s": oracle_s,
          "oracle_mismatches": bad[:8], "agree": agree,
          "reference_counters": counters, "dispatched_docs": dispatched,
          "k5_launches_ok": path_ok, "overflowed_in_chunk": overflowed,
          "k6_launches_grown": launches["tree_grown"]["splice_rows"],
          "splice_rows": splice,
          "k5": {k: {x: v for x, v in r.items() if x not in (
              "name", "route", "source", "replaces")}
              for k, r in rows.items()}})
    if not all(agree.values()):
        raise AssertionError(f"tree passes disagree: {agree}")
    if bad:
        raise AssertionError(f"tree summaries differ from the oracle: "
                             f"{bad[:8]}")
    if not all(c["equal"] for c in counters.values()):
        raise AssertionError(f"tree counters differ from the reference's: "
                             f"{counters}")
    exact = passes["exact"]
    if exact["h2d_bytes"] != 0 or exact["d2h_bytes"] != 8 * dispatched:
        raise AssertionError(f"exact tree pass moved h2d "
                             f"{exact['h2d_bytes']} / d2h "
                             f"{exact['d2h_bytes']} B; want 0 / "
                             f"{8 * dispatched}")
    if launches["tree_grown"]["splice_rows"] < 1:
        raise AssertionError("no splice on the grown tree pass")
    if not all(path_ok.values()):
        raise AssertionError(f"tree kernel launches off their paths: "
                             f"{path_ok} {launches}")
    if err_fold or err_digest:
        raise AssertionError(f"tree kernel != plain: fold {err_fold}, "
                             f"digest build {err_digest}")
    return [rows["tree_fold"], rows["tree_fold_digest"]], {
        "launches": launches["tree_grown"]["splice_rows"],
        "path": "tree_grown", **splice}


def entry_walls(fn, calls):
    """Host seconds of ``calls`` calls of an entry point, each timed on
    the host clock and ending in ``torch.cuda.synchronize()``."""
    import torch

    walls = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return walls


def lww_library_chain(x, num_docs):
    """The LWW reduction as a chain of library calls: four
    ``scatter_reduce_`` (``"amax"``, from INT32_MIN) and two gathers,
    without the plain version's segment-id guards (the packer's ids are in
    range).  K7's ``library_ms`` yardstick; the port never calls it."""
    import torch

    def seg(values, ids, n):
        return torch.full((n,), -2 ** 31, dtype=torch.int32,
                          device=values.device).scatter_reduce_(
            0, ids, values, "amax")

    G = x.key_doc.shape[0]
    gid = x.key_gid.long()
    max_seq = seg(x.op_seq, gid, G)
    last_clear = seg(x.clear_seq, x.clear_doc.long(), num_docs)
    winner = x.op_seq == max_seq[gid]
    win_set = seg(torch.where(winner, x.is_set, -1), gid, G)
    win_val = seg(torch.where(winner, x.val_idx, -1), gid, G)
    return (win_set == 1) & (max_seq > last_clear[x.key_doc.long()]), win_val


def map_phase(dev, drive, launches, card):
    """Phase 9: SharedMap catch-up at full width (BASELINE.json config #2,
    the reference's ``gen_map_doc`` workload): ``replay_map_batch`` over
    10,240 documents x 96 ops on the card, with one launch of the LWW
    kernel (K7), ``stats`` counting every document on the device and every
    summary byte-identical to the port's ``SharedMap`` oracle; the same
    batch staged by hand (pack, upload, kernel, download, summaries) and
    the entry's rate (median of 3 calls); K7 against its plain version and
    the library chain on the card, bit-equal on every key entry (padding
    included), on the main batch, the committed fixture and the crafted
    empty-segment cases; K7 timed.  Returns K7's row of the ``kernels``
    line."""
    import torch

    from fluidframework_tpu_torch.ops import map_kernel as mp
    from fluidframework_tpu_torch.ops import map_lww_cuda
    from fluidframework_tpu_torch.testing import config_workloads as cw

    t = time.perf_counter()
    docs = [cw.gen_map_doc(i, MAP_OPS) for i in range(MAP_DOCS)]
    gen_s = time.perf_counter() - t
    n_ops = sum(len(d.ops) for d in docs)
    stats = {}
    got, e2e_s = drive("map", lambda: mp.replay_map_batch(
        docs, stats=stats, device=dev))
    t = time.perf_counter()
    bad = [d.doc_id for d, g in zip(docs, got)
           if g.digest() != mp.oracle_map_summary(d).digest()]
    oracle_s = time.perf_counter() - t
    walls = [e2e_s] + entry_walls(
        lambda: mp.replay_map_batch(docs, device=dev), ENTRY_CALLS - 1)

    stages = {}
    t = time.perf_counter()
    batch = mp.pack_map_batch(docs)
    stages["pack"] = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    inputs = mp.lww_inputs(batch, dev)
    torch.cuda.synchronize()
    stages["upload"] = time.perf_counter() - t
    t = time.perf_counter()
    present, win_val = map_lww_cuda.lww(inputs, batch.num_docs)
    torch.cuda.synchronize()
    stages["kernel"] = time.perf_counter() - t
    t = time.perf_counter()
    present_h, win_val_h = present.cpu(), win_val.cpu()
    stages["download"] = time.perf_counter() - t
    t = time.perf_counter()
    staged = mp.summaries_from_lww(batch, present_h, win_val_h)
    stages["summaries"] = time.perf_counter() - t
    staged_same = [x.digest() for x in staged] == [x.digest() for x in got]

    parity = {}
    for label, b in [("main", batch),
                     ("fixture", mp.pack_map_batch(cw.hard_map_docs()))] + [
            (f"crafted-{c}", mp.pack_map_batch(cw.crafted_map_docs(c)))
            for c in cw.CRAFTED_MAP]:
        x = mp.lww_inputs(b, dev)
        kernel = map_lww_cuda.lww(x, b.num_docs)
        plain = mp.map_lww_reference(x, b.num_docs)
        library = lww_library_chain(x, b.num_docs)
        torch.cuda.synchronize()
        parity[label] = max(leaves_diff(plain, kernel),
                            leaves_diff(library, kernel))
    err = max(parity.values())

    fn = lambda: map_lww_cuda.lww(inputs, batch.num_docs)  # noqa: E731
    ms, runs = time_call(fn)
    call_ms, _ = time_call(fn, spin=False)
    _o, plain_ms = timed_once(
        lambda: mp.map_lww_reference(inputs, batch.num_docs))
    library_ms, library_runs = time_call(
        lambda: lww_library_chain(inputs, batch.num_docs))
    N, G, M = (inputs.key_gid.shape[0], inputs.key_doc.shape[0],
               inputs.clear_doc.shape[0])
    bound = bytes_bound(nbytes(tuple(inputs)) + G * (1 + 4), N + G + M)
    k7 = launches["map"]["map_lww"]
    emit({"phase": "map", "docs": MAP_DOCS, "ops": n_ops,
          "shape": {"N": N, "G": G, "M": M, "keys": len(batch.keys)},
          "launches": launches["map"], "stats": stats,
          "oracle_docs": len(docs), "oracle_mismatches": bad[:8],
          "gen_s": gen_s, "oracle_s": oracle_s, "e2e_s": e2e_s,
          "walls_s": walls, "ops_per_s": n_ops / statistics.median(walls),
          "stages_s": stages, "staged_equals_entry": staged_same,
          "max_abs_err_by_batch": parity, "kernel_ms": ms,
          "kernel_runs_ms": runs, "call_ms": call_ms, "plain_ms": plain_ms,
          "library_ms": library_ms, "library_runs_ms": library_runs,
          "bound": bound})
    if k7 != 1:
        raise AssertionError(f"replay_map_batch launched the map kernel "
                             f"{k7} times, not once: {launches['map']}")
    if stats != {"device_docs": MAP_DOCS}:
        raise AssertionError(f"map stats {stats}")
    if bad:
        raise AssertionError(f"map summaries differ from the oracle: {bad[:8]}")
    if not staged_same:
        raise AssertionError("the staged map batch differs from the entry")
    if err:
        raise AssertionError(f"map kernel != plain / library chain: {parity}")
    return {"name": "map_lww", "route": "cuda", "source": MAP_SOURCE,
            "replaces": MAP_REPLACES, "launches": k7, "path": "map",
            "timed_shape": [N, G, M], "max_abs_err": err, "tolerance": 0,
            "parity": err == 0, "max_abs_err_by_batch": parity, "ms": ms,
            "runs_ms": runs, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "bound": bound, "library_ms": library_ms,
            "library": "torch scatter_reduce_ amax chain (4 calls and 2 "
                       "gathers)", "card": card}


def matrix_phase(dev, drive, launches, card):
    """Phase 10: SharedMatrix catch-up at full width (BASELINE.json config
    #4, the reference's ``gen_matrix_doc`` workload):
    ``replay_matrix_batch`` over 10,240 documents x 64 ops (20,480 axis
    streams) on the card, with one launch of the resolving build (K4) in
    shared memory and every summary byte-identical to the port's
    ``SharedMatrix`` oracle; the same batch staged by hand and the entry's
    rate (median of 3 calls); the committed fixture through the entry
    (summaries against the oracle, routing counts equal to the JAX
    package's); the resolving build against the plain
    ``replay_scan_resolving`` on the card (every plane, ``n``,
    ``overflow`` and every resolved handle) on the main batch, the fixture
    and the crafted resolve cases, and on 16 documents of 2,048 ops
    (S = 4,096), which take the device-memory build through the entry; both
    builds timed.  Returns their rows of the ``kernels`` line."""
    import torch

    from fluidframework_tpu_torch.convert import tensors_to
    from fluidframework_tpu_torch.ops import fold_cuda
    from fluidframework_tpu_torch.ops import matrix_kernel as mk
    from fluidframework_tpu_torch.testing import config_workloads as cw

    t = time.perf_counter()
    docs = [cw.gen_matrix_doc(i, MATRIX_OPS) for i in range(MATRIX_DOCS)]
    gen_s = time.perf_counter() - t
    n_ops = sum(len(d.ops) for d in docs)
    stats = {}
    got, e2e_s = drive("matrix", lambda: mk.replay_matrix_batch(
        docs, stats=stats, device=dev))
    t = time.perf_counter()
    bad = [d.doc_id for d, g in zip(docs, got)
           if g.digest() != mk.oracle_matrix_fallback(d).digest()]
    oracle_s = time.perf_counter() - t
    walls = [e2e_s] + entry_walls(
        lambda: mk.replay_matrix_batch(docs, device=dev), ENTRY_CALLS - 1)

    stages = {}
    t = time.perf_counter()
    st_np, ops_np, meta = mk.pack_matrix_batch(docs)
    stages["pack"] = time.perf_counter() - t
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, ops = tensors_to(st_np, dev), tensors_to(ops_np, dev)
    torch.cuda.synchronize()
    stages["upload"] = time.perf_counter() - t
    t = time.perf_counter()
    final, resolved = fold_cuda.fold_resolving(state, ops)
    torch.cuda.synchronize()
    stages["kernel"] = time.perf_counter() - t
    t = time.perf_counter()
    state_h = {k: v.cpu().numpy() for k, v in final._asdict().items()}
    resolved_h = resolved.cpu().numpy()
    stages["download"] = time.perf_counter() - t
    t = time.perf_counter()
    staged = [mk.summary_from_matrix_state(meta, state_h, resolved_h, d)
              for d in range(len(docs))]
    stages["summaries"] = time.perf_counter() - t
    staged_same = [x.digest() for x in staged] == [x.digest() for x in got]
    D2, S = st_np.tstart.shape
    T = ops_np.kind.shape[1]

    parity = {"smem": {}, "gmem": {}}

    def check(label, st, op):
        where = fold_cuda.placement(st.tstart.shape[1], 1)
        got_f, got_r = fold_cuda.fold_resolving(st, op)
        (want_f, want_r), plain = timed_once(
            lambda: mk.replay_scan_resolving(st, op))
        err_f, first = state_diff(want_f, got_f)
        err = max(err_f, leaves_diff(want_r, got_r))
        if err:
            print(f"resolving fold vs plain ({label}): first state mismatch "
                  f"{first}", file=sys.stderr)
        parity[where][label] = err
        return plain

    plain_ms = check("main", state, ops)
    fixture = cw.hard_matrix_docs()
    fx_np = mk.pack_matrix_batch([d for d in fixture
                                  if not mk.known_matrix_fallback(d)])
    check("fixture", tensors_to(fx_np[0], dev), tensors_to(fx_np[1], dev))
    cr_np = mk.pack_matrix_batch([cw.crafted_matrix_doc(c)
                                  for c in cw.CRAFTED_MATRIX])
    check("crafted", tensors_to(cr_np[0], dev), tensors_to(cr_np[1], dev))
    fx_stats = {}
    fx_got = mk.replay_matrix_batch(fixture, stats=fx_stats, device=dev)
    fx_bad = [d.doc_id for d, g in zip(fixture, fx_got)
              if g.digest() != mk.oracle_matrix_fallback(d).digest()]

    t = time.perf_counter()
    g_docs = [cw.gen_matrix_doc(i, MATRIX_GMEM_OPS)
              for i in range(MATRIX_GMEM_DOCS)]
    g_np, g_ops_np, _g_meta = mk.pack_matrix_batch(g_docs)
    g_pack_s = time.perf_counter() - t
    gD2, gS = g_np.tstart.shape
    gT = g_ops_np.kind.shape[1]
    g_where = fold_cuda.placement(gS, 1)
    g_stats = {}
    g_got, g_e2e_s = drive("matrix_gmem", lambda: mk.replay_matrix_batch(
        g_docs, stats=g_stats, device=dev))
    g_state, g_ops = tensors_to(g_np, dev), tensors_to(g_ops_np, dev)
    g_plain_ms = check("large_s", g_state, g_ops)
    t = time.perf_counter()
    g_bad = [d.doc_id for d, g in zip(g_docs[:2], g_got)
             if g.digest() != mk.oracle_matrix_fallback(d).digest()]
    g_oracle_s = time.perf_counter() - t

    times = {}
    for where, st, op, shape, plain in (
            ("smem", state, ops, (D2, S, T), plain_ms),
            ("gmem", g_state, g_ops, (gD2, gS, gT), g_plain_ms)):
        fn = lambda st=st, op=op: fold_cuda.fold_resolving(st, op)  # noqa
        k_ms, k_runs = time_call(fn)
        k_call_ms, _ = time_call(fn, spin=False)
        d2, s_, t_ = shape
        bound = bound_ms(st, op, state_out_bytes(d2, s_, t_, 1) + d2 * t_ * 4)
        times[where] = {"shape": [d2, s_, t_, 1], "ms": k_ms,
                        "runs_ms": k_runs, "call_ms": k_call_ms,
                        "plain_ms": plain, "bound": bound,
                        "resolve_rows": int((op.kind == mk.K_RESOLVE).sum())}
    k4 = {"smem": launches["matrix"]["fold_resolving_smem"],
          "gmem": launches["matrix_gmem"]["fold_resolving_gmem"]}
    emit({"phase": "matrix", "docs": MATRIX_DOCS, "ops": n_ops,
          "shape": [D2, S, T, 1], "launches": launches["matrix"],
          "stats": stats, "oracle_docs": len(docs),
          "oracle_mismatches": bad[:8], "gen_s": gen_s, "oracle_s": oracle_s,
          "e2e_s": e2e_s, "walls_s": walls,
          "ops_per_s": n_ops / statistics.median(walls), "stages_s": stages,
          "staged_equals_entry": staged_same,
          "fixture": {"docs": len(fixture), "stats": fx_stats,
                      "reference_stats": MATRIX_FIXTURE_STATS,
                      "oracle_mismatches": fx_bad},
          "large_s": {"docs": MATRIX_GMEM_DOCS, "ops": MATRIX_GMEM_OPS,
                      "shape": [gD2, gS, gT, 1], "placement": g_where,
                      "pack_s": g_pack_s, "e2e_s": g_e2e_s,
                      "stats": g_stats, "launches": launches["matrix_gmem"],
                      "oracle_docs": 2, "oracle_mismatches": g_bad,
                      "oracle_s": g_oracle_s},
          "max_abs_err_by_batch": parity, "times": times})
    if k4["smem"] != 1 or sum(launches["matrix"].values()) != 1:
        raise AssertionError(f"replay_matrix_batch did not launch the "
                             f"resolving build once in shared memory: "
                             f"{launches['matrix']}")
    if g_where != "gmem" or k4["gmem"] != 1:
        raise AssertionError(f"the S={gS} matrix batch did not fold once in "
                             f"device memory ({g_where}): "
                             f"{launches['matrix_gmem']}")
    if stats != {"device_docs": MATRIX_DOCS}:
        raise AssertionError(f"matrix stats {stats}")
    if bad or fx_bad or g_bad:
        raise AssertionError(f"matrix summaries differ from the oracle: "
                             f"{(bad + fx_bad + g_bad)[:8]}")
    if not staged_same:
        raise AssertionError("the staged matrix batch differs from the entry")
    if fx_stats != MATRIX_FIXTURE_STATS:
        raise AssertionError(f"fixture routing {fx_stats}, the JAX "
                             f"package's {MATRIX_FIXTURE_STATS}")
    err = max(v for by in parity.values() for v in by.values())
    if err:
        raise AssertionError(f"resolving fold != plain: {parity}")
    rows = []
    for where, path in (("smem", "matrix"), ("gmem", "matrix_gmem")):
        rec, e = times[where], max(parity[where].values())
        rows.append({
            "name": f"matrix_fold_resolve_{where}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": MATRIX_REPLACES,
            "placement": where, "launches": k4[where], "path": path,
            "timed_shape": rec["shape"], "max_abs_err": e, "tolerance": 0,
            "parity": e == 0, "max_abs_err_by_batch": parity[where],
            "ms": rec["ms"], "runs_ms": rec["runs_ms"],
            "call_ms": rec["call_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound"]["bound_ms"],
            "bound_by": rec["bound"]["bound_by"], "bound": rec["bound"],
            "resolve_rows": rec["resolve_rows"], "library_ms": None,
            "library": "none: no one PyTorch call computes the axis fold "
                       "with resolution", "card": card})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "fluidframework_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(fluidframework_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from fluidframework_tpu_torch.convert import tensors_to
    from fluidframework_tpu_torch.ops import _cuda_build, fold_cuda
    from fluidframework_tpu_torch.ops import mergetree_kernel as mt
    from fluidframework_tpu_torch.ops.pipeline import (
        pipelined_mergetree_replay)
    from fluidframework_tpu_torch.testing import workload

    t_run = time.perf_counter()
    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    launches = {}  # driven path -> launches of each build in that run
    parity = {"fold_smem": {}, "fold_gmem": {}, "fold_export_smem": {},
              "fold_export_gmem": {}}

    def drive(path, fn):
        """Run a path with every count at 0 before it, read after it."""
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches[path] = read_counts()
        return out, seconds

    def digests(summaries):
        return [s.digest() for s in summaries]

    # -- 0. card and build ------------------------------------------------
    built = build_all()
    occ = [fold_cuda.occupancy(S, 1, kernel=k)
           for S in (PINNED_S, TAIL_S, LARGE_S)
           for k in ("fold", "fold_export", "fold_resolving")]
    ptxas = {}
    for source in ("mergetree_fold", "resident", "tree_fold", "map_lww"):
        with open(_cuda_build.library_path(source) + ".log") as f:
            ptxas[source] = [ln.strip() for ln in f if "registers" in ln
                             or "spill" in ln or "smem" in ln]
    emit({"phase": "build", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "seconds": {k: v[1] for k, v in built.items()},
          "ptxas": ptxas, "occupancy": occ})

    # -- 1. kernel vs plain on the hard-semantics fixture -----------------
    fixture = workload.hard_docs()
    state_np, ops_np, _meta = mt.pack_mergetree_batch(fixture)
    state = tensors_to(state_np, dev)
    ops = tensors_to(ops_np, dev)
    err, _plain_ms, got = kernel_vs_plain(state, ops)
    parity["fold_smem"]["fixture"] = err
    over = got.overflow.cpu().tolist()
    emit({"phase": "hard_semantics", "docs": [d.doc_id for d in fixture],
          "shape": list(state_np.props.shape) + [ops_np.kind.shape[1]],
          "max_abs_err": err, "tolerance": 0, "overflow": over})
    if err != 0:
        raise AssertionError(f"kernel != plain fold on the fixture: {err}")
    if not over[-1]:
        raise AssertionError("the overflow document did not overflow")

    # -- 2. the first slice's main path at full width ----------------------
    t = time.perf_counter()
    docs = [workload.synth_doc(i, N_OPS) for i in range(N_DOCS)]
    synth_s = time.perf_counter() - t
    stats = {}
    summaries, e2e_s = drive("batch", lambda: mt.replay_mergetree_batch(
        docs, stats=stats, device=dev))
    n_ops = N_DOCS * N_OPS
    if launches["batch"]["fold_export_smem"] != 1:
        raise AssertionError(f"the one-batch entry did not launch the "
                             f"fold+export kernel once: {launches['batch']}")
    step = max(1, N_DOCS // ORACLE_SAMPLE)
    sample = list(range(0, N_DOCS, step))[:ORACLE_SAMPLE]
    t = time.perf_counter()
    oracle = {i: workload.oracle_replay(docs[i]).summarize().digest()
              for i in sample}
    oracle_s = time.perf_counter() - t
    mismatched = [docs[i].doc_id for i in sample
                  if summaries[i].digest() != oracle[i]]
    emit({"phase": "main_path", "docs": N_DOCS, "ops": n_ops,
          "launches": launches["batch"], "stats": stats,
          "oracle_sample": len(sample), "oracle_mismatches": mismatched,
          "synth_s": synth_s, "e2e_s": e2e_s,
          "oracle_sample_s": oracle_s})
    if mismatched:
        raise AssertionError(f"summaries differ from the oracle: "
                             f"{mismatched[:8]}")
    if len(summaries) != N_DOCS:
        raise AssertionError("summary count")

    # The same batch staged by hand.
    t = time.perf_counter()
    state_np, ops_np, meta = mt.pack_mergetree_batch(docs)
    pack_s = time.perf_counter() - t
    D, S = state_np.tstart.shape
    T, K = ops_np.kind.shape[1], state_np.props.shape[2]
    layout = mt._export_flags(meta)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ops_n = tensors_to(mt.narrow_ops_for_upload(ops_np, meta), dev)
    base = torch.from_numpy(meta["doc_base"]).to(dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    t = time.perf_counter()
    export = fold_cuda.fold_export(None, ops_n, base, layout, S=S)
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t
    t = time.perf_counter()
    export_np = mt.export_to_numpy(export)
    download_s = time.perf_counter() - t
    t = time.perf_counter()
    staged = mt.summaries_from_export(meta, export_np)
    summaries_s = time.perf_counter() - t
    if digests(staged[:64]) != digests(summaries[:64]):
        raise AssertionError("staged run differs from the entry point")
    if S != PINNED_S:
        raise AssertionError(f"the pinned batch packed to S={S}, "
                             f"not {PINNED_S}")

    # The state path over the same batch, against the plain fold.
    ops = tensors_to(ops_np, dev)
    state = mt.cold_start(ops, S)
    final, _ = drive("state", lambda: fold_cuda.fold(state, ops))
    want, plain_ms = timed_once(lambda: mt.fold_reference(state, ops))
    err = max(state_diff(want, final)[0],
              leaves_diff(mt.export_state(want), mt.export_state(final)))
    parity["fold_smem"]["main"] = err
    emit({"phase": "main_batch_parity", "shape": [D, S, T, K],
          "layout": layout, "max_abs_err": err, "tolerance": 0,
          "plain_ms": plain_ms, "launches": launches["state"]})
    if err != 0:
        raise AssertionError(f"kernel != plain fold on the main batch: {err}")

    # -- 3. long tail: S = 3,072 in shared memory -------------------------
    tail_docs = [workload.synth_doc(i, TAIL_OPS) for i in range(TAIL_DOCS)]
    tail_np, tail_ops_np, _meta = mt.pack_mergetree_batch(tail_docs)
    tail_ops = tensors_to(tail_ops_np, dev)
    tail_state = tensors_to(tail_np, dev)
    if tail_np.tstart.shape[1] != TAIL_S:
        raise AssertionError(f"the long tail packed to "
                             f"S={tail_np.tstart.shape[1]}, not {TAIL_S}")
    tail_err, tail_plain_ms, _ = kernel_vs_plain(tail_state, tail_ops)
    parity["fold_smem"]["long_tail"] = tail_err
    tail_ms, tail_runs = time_call(lambda: fold_cuda.fold(tail_state,
                                                          tail_ops))
    emit({"phase": "long_tail", "shape": list(tail_np.props.shape)
          + [tail_ops_np.kind.shape[1]], "max_abs_err": tail_err,
          "tolerance": 0, "kernel_ms": tail_ms, "kernel_runs_ms": tail_runs,
          "plain_ms": tail_plain_ms,
          "placement": fold_cuda.placement(TAIL_S, 1)})
    if tail_err != 0:
        raise AssertionError(f"kernel != plain fold on the long tail: "
                             f"{tail_err}")

    # -- 4. large S: the device-memory placement --------------------------
    # A full wave: as many documents as the device-memory build keeps
    # resident on the card at once, so they share each SM's L1 as a real
    # chunk of long documents does.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = fold_cuda.occupancy(LARGE_S, 1)["docs_per_sm"]
    wave = per_sm * sms
    t = time.perf_counter()
    wave_docs = [workload.synth_doc(i, LARGE_OPS) for i in range(wave)]
    wave_synth_s = time.perf_counter() - t
    large_docs = wave_docs[:LARGE_DOCS]
    lg_np, lg_ops_np, lg_meta = mt.pack_mergetree_batch(wave_docs)
    lg_S, lg_T = lg_np.tstart.shape[1], lg_ops_np.kind.shape[1]
    if lg_S != LARGE_S or fold_cuda.placement(lg_S, 1) != "gmem":
        raise AssertionError(f"the large batch packed to S={lg_S} "
                             f"({fold_cuda.placement(lg_S, 1)}), not "
                             f"{LARGE_S} in device memory")
    lg_ops = tensors_to(lg_ops_np, dev)
    lg_state = tensors_to(lg_np, dev)
    lg_final, _ = drive("large_state",
                        lambda: fold_cuda.fold(lg_state, lg_ops))
    lg_want, lg_plain_ms = timed_once(
        lambda: mt.fold_reference(lg_state, lg_ops))
    lg_err, lg_first = state_diff(lg_want, lg_final)
    lg_err = max(lg_err, leaves_diff(mt.export_state(lg_want),
                                     mt.export_state(lg_final)))
    parity["fold_gmem"]["large_s"] = lg_err
    if lg_err != 0:
        raise AssertionError(f"kernel != plain fold in device memory at S="
                             f"{lg_S}: {lg_err}, first {lg_first}")
    lg_ms, lg_runs = time_call(lambda: fold_cuda.fold(lg_state, lg_ops))
    lg_call_ms, _ = time_call(lambda: fold_cuda.fold(lg_state, lg_ops),
                              spin=False)
    # The first LARGE_DOCS documents alone: one a SM, each with an L1 to
    # itself (the same rows of the same tensors, so the wave's result is
    # their yardstick).
    few_state = mt.MTState(*(x[:LARGE_DOCS] for x in lg_state))
    few_ops = mt.MTOps(*(x[:LARGE_DOCS] for x in lg_ops))
    few_err, _ = state_diff(mt.MTState(*(x[:LARGE_DOCS] for x in lg_final)),
                            fold_cuda.fold(few_state, few_ops))
    parity["fold_gmem"]["large_s_one_per_sm"] = few_err
    few_ms, few_runs = time_call(lambda: fold_cuda.fold(few_state, few_ops))
    lg_summaries, lg_pipe_s = drive(
        "large_pipeline",
        lambda: pipelined_mergetree_replay(wave_docs, device=dev))
    lg_batch = mt.replay_mergetree_batch(wave_docs, device=dev)
    lg_oracle = [workload.oracle_replay(d).summarize().digest()
                 for d in wave_docs[:2]]
    bytes_per_doc = fold_cuda.occupancy(lg_S, 1)["bytes_per_doc"]
    emit({"phase": "large_s", "shape": [wave, lg_S, lg_T, 1],
          "sms": sms, "docs_per_sm": per_sm, "bytes_per_doc": bytes_per_doc,
          "scratch_bytes": wave * bytes_per_doc, "synth_s": wave_synth_s,
          "max_abs_err": lg_err, "tolerance": 0, "kernel_ms": lg_ms,
          "kernel_runs_ms": lg_runs, "kernel_call_ms": lg_call_ms,
          "plain_ms": lg_plain_ms, "launches": launches["large_state"],
          "one_per_sm": {"docs": LARGE_DOCS, "max_abs_err": few_err,
                         "kernel_ms": few_ms, "kernel_runs_ms": few_runs},
          "pipeline_launches": launches["large_pipeline"],
          "pipeline_s": lg_pipe_s,
          "pipeline_equals_batch": digests(lg_summaries)
          == digests(lg_batch),
          "oracle_identical": digests(lg_summaries[:2]) == lg_oracle})
    if few_err != 0:
        raise AssertionError(f"the one-per-SM launch differs from the "
                             f"wave's: {few_err}")
    if digests(lg_summaries) != digests(lg_batch) \
            or digests(lg_summaries[:2]) != lg_oracle:
        raise AssertionError("large-S summaries differ from the one-batch "
                             "entry or the oracle")

    # -- 5. layouts: the fold+export build against the plain chain ---------
    layout_corpora = [
        ("fixture", mt.pack_mergetree_batch(fixture), ["warm"]),
        ("main", (state_np, ops_np, meta), ["cold", "warm"]),
        ("obliterate_lagged",
         mt.pack_mergetree_batch(workload.cold_fixture_docs(8)),
         ["cold", "warm"]),
        ("large_s", mt.pack_mergetree_batch(large_docs), ["cold"]),
    ]
    n_combos = 0
    for corpus, (c_st, c_ops, c_meta), warmths in layout_corpora:
        c_S = c_st.tstart.shape[1]
        c_base = torch.from_numpy(c_meta["doc_base"]).to(dev)
        plain = PlainExport(c_S, c_base)
        where = fold_cuda.placement(c_S, c_st.props.shape[2])
        for label, m in workload.layout_metas(c_meta):
            c_layout = mt._export_flags(m)
            o = tensors_to(mt.narrow_ops_for_upload(c_ops, m), dev)
            for warmth in warmths:
                st = None if warmth == "cold" else tensors_to(
                    mt.narrow_state_for_upload(c_st, m), dev)
                for digest in (False, True):
                    got = fold_cuda.fold_export(st, o, c_base, c_layout,
                                                digest, S=c_S)
                    err = leaves_diff(plain(st, o, c_layout, digest), got)
                    key = f"fold_export_{where}"
                    parity[key][corpus] = max(parity[key].get(corpus, 0),
                                              err)
                    emit({"phase": "layout", "corpus": corpus,
                          "layout": label, "warmth": warmth,
                          "digest": digest, "placement": where,
                          "ops": str(o.seq.dtype).split(".")[-1],
                          "leaves": [[str(x.dtype).split(".")[-1],
                                      list(x.shape)]
                                     for x in (got if isinstance(got, tuple)
                                               else (got,))],
                          "max_abs_err": err})
                    if err != 0:
                        raise AssertionError(
                            f"fold+export != plain: {corpus} {label} "
                            f"{warmth} digest={digest}: {err}")
                    n_combos += 1

    # -- 6. the pipelined path at full width -------------------------------
    stage, p_stats, packed = {}, {}, []
    p_summaries, pipe_s = drive("pipeline", lambda: pipelined_mergetree_replay(
        docs, chunk_docs=CHUNK_DOCS, stats=p_stats, stage=stage,
        packed_out=packed, device=dev))
    same = digests(p_summaries) == digests(summaries)
    p_mismatched = [docs[i].doc_id for i in sample
                    if p_summaries[i].digest() != oracle[i]]
    want_h2d, want_d2h = expected_transfer(packed)
    rates = []
    for turn in TURNS:
        run = (lambda: pipelined_mergetree_replay(docs, device=dev)) \
            if turn == "P" else \
            (lambda: mt.replay_mergetree_batch(docs, device=dev))
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        rates.append([turn, n_ops / (time.perf_counter() - t)])
    emit({"phase": "pipeline", "docs": N_DOCS, "ops": n_ops,
          "chunks": len(packed), "launches": launches["pipeline"],
          "stats": p_stats, "stage": stage, "e2e_s": pipe_s,
          "ops_per_s": n_ops / pipe_s,
          "equals_batch": same, "oracle_sample": len(sample),
          "oracle_mismatches": p_mismatched,
          "h2d_bytes": stage["h2d_bytes"], "h2d_bytes_expected": want_h2d,
          "d2h_bytes": stage["d2h_bytes"], "d2h_bytes_expected": want_d2h,
          "turns_ops_per_s": rates,
          "median_ops_per_s": {
              side: statistics.median(r for x, r in rates if x == side)
              for side in "PB"}})
    if launches["pipeline"]["fold_export_smem"] != len(packed):
        raise AssertionError(f"the pipeline did not launch the fold+export "
                             f"kernel once a chunk: {launches['pipeline']}")
    if not same or p_mismatched:
        raise AssertionError("pipelined summaries differ from the one-batch "
                             f"entry ({same}) or the oracle "
                             f"({p_mismatched[:8]})")
    if (stage["h2d_bytes"], stage["d2h_bytes"]) != (want_h2d, want_d2h):
        raise AssertionError("pipelined byte counters differ from the "
                             "layout's")

    # -- 7. the warm catch-up path at full width ---------------------------
    k6_rows = warm_phase(dev, docs, sample, drive, launches)

    # -- 8. SharedTree catch-up at full width ------------------------------
    k5_rows, tree_splice = tree_phase(dev, drive, launches)
    k6_rows[0]["tree_grown"] = tree_splice

    # -- 9. SharedMap catch-up at full width -------------------------------
    k7_row = map_phase(dev, drive, launches, card)

    # -- 10. SharedMatrix catch-up at full width ---------------------------
    k4_rows = matrix_phase(dev, drive, launches, card)

    # -- 11. times ---------------------------------------------------------
    ms, runs = time_call(lambda: fold_cuda.fold(state, ops))
    call_ms, _ = time_call(lambda: fold_cuda.fold(state, ops), spin=False)
    bound = bound_ms(state, ops, state_out_bytes(D, S, T, K))
    lg_bound = bound_ms(lg_state, lg_ops, state_out_bytes(
        wave, lg_S, lg_T, 1))

    def fused(corpus, st_ops, fold_ops, fused_ops, c_base, c_layout, c_S):
        """Times and bound of the fold+export build on a cold chunk (the
        narrow ops in and the export out, no state read or written), held
        against the plain chain on the same inputs."""
        fn = lambda: fold_cuda.fold_export(None, fused_ops, c_base,  # noqa
                                           c_layout, S=c_S)
        f_ms, f_runs = time_call(fn)
        f_call_ms, _ = time_call(fn, spin=False)
        out = fn()
        want, f_plain_ms = timed_once(lambda: mt.export_reference(
            None, fused_ops, c_base, c_layout, S=c_S))
        key = f"fold_export_{fold_cuda.placement(c_S, 1)}"
        err = leaves_diff(want, out)
        parity[key][corpus] = max(parity[key].get(corpus, 0), err)
        if err != 0:
            raise AssertionError(f"fold+export != plain on the timed "
                                 f"{corpus} chunk: {err}")
        D_, T_ = fused_ops.kind.shape
        rows = (out[0] if isinstance(out, tuple) else out).shape[1]
        moved = nbytes(tuple(fused_ops)) + nbytes(c_base) + nbytes(out)
        f_bound = bound_ms(st_ops, fold_ops, moved,
                           extra_ops=D_ * rows * c_S)
        return f_ms, f_runs, f_call_ms, f_plain_ms, f_bound

    fx = fused("main", state, ops, ops_n, base, layout, S)
    lg_ops_n = tensors_to(mt.narrow_ops_for_upload(lg_ops_np, lg_meta), dev)
    lg_base = torch.from_numpy(lg_meta["doc_base"]).to(dev)
    lg_layout = mt._export_flags(lg_meta)
    lg_fx = fused("large_s", lg_state, lg_ops, lg_ops_n, lg_base,
                  lg_layout, lg_S)
    staged_s = pack_s + upload_s + fold_s + download_s + summaries_s
    emit({"phase": "times", "card": card,
          "fold_smem": {"ms": ms, "runs_ms": runs, "call_ms": call_ms,
                        "plain_ms": plain_ms, "bound": bound,
                        "gap_to_bound": ms / bound["bound_ms"]},
          "fold_gmem": {"ms": lg_ms, "call_ms": lg_call_ms,
                        "plain_ms": lg_plain_ms, "bound": lg_bound,
                        "gap_to_bound": lg_ms / lg_bound["bound_ms"]},
          "fold_export_smem": {"ms": fx[0], "runs_ms": fx[1],
                               "call_ms": fx[2], "plain_ms": fx[3],
                               "bound": fx[4], "layout": layout,
                               "gap_to_bound": fx[0] / fx[4]["bound_ms"]},
          "fold_export_gmem": {"ms": lg_fx[0], "call_ms": lg_fx[2],
                               "plain_ms": lg_fx[3], "bound": lg_fx[4],
                               "layout": lg_layout,
                               "gap_to_bound":
                                   lg_fx[0] / lg_fx[4]["bound_ms"]},
          "occupancy": occ, "e2e_ops_per_s": n_ops / e2e_s,
          "stages_s": {"pack": pack_s, "upload": upload_s,
                       "fold_export": fold_s, "download": download_s,
                       "summaries": summaries_s},
          "staged_ops_per_s": n_ops / staged_s, "layout_combos": n_combos,
          "run_s": time.perf_counter() - t_run})

    def entry(name_, where, path, shape, err_by_batch, t_ms, t_call_ms,
              t_plain_ms, t_bound):
        n = launches[path][name_]
        if n < 1:
            raise AssertionError(f"{name_}: no launch on its path {path}")
        err = max(err_by_batch.values())
        return {"name": f"mergetree_{name_}", "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": TPU_KERNEL, "placement": where,
                "launches": n, "path": path, "timed_shape": shape,
                "max_abs_err": err, "tolerance": 0, "parity": err == 0,
                "max_abs_err_by_batch": err_by_batch, "ms": t_ms,
                "call_ms": t_call_ms, "plain_ms": t_plain_ms,
                "bound_ms": t_bound["bound_ms"],
                "bound_by": t_bound["bound_by"], "library_ms": None,
                "library": "none: no one PyTorch call computes the "
                           "merge-tree fold", "card": card}

    emit({"kernels": [
        entry("fold_smem", "smem", "state", [D, S, T, K],
              parity["fold_smem"], ms, call_ms, plain_ms, bound),
        entry("fold_gmem", "gmem", "large_state", [wave, lg_S, lg_T, 1],
              parity["fold_gmem"], lg_ms, lg_call_ms, lg_plain_ms, lg_bound),
        entry("fold_export_smem", "smem", "pipeline", [D, S, T, K],
              parity["fold_export_smem"], fx[0], fx[2], fx[3], fx[4]),
        entry("fold_export_gmem", "gmem", "large_pipeline",
              [wave, lg_S, lg_T, 1], parity["fold_export_gmem"], lg_fx[0],
              lg_fx[2], lg_fx[3], lg_fx[4]),
    ] + [dict(r, card=card) for r in k6_rows + k5_rows] + k4_rows
        + [k7_row]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
