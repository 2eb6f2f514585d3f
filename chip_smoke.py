#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (built for an H100, sm_90a).

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports
only the port (``fluidframework_tpu_torch``), torch and numpy, builds the
port's libraries from the sources in the checkout, and runs in order:

0. card and build — the card's name and power limit, then the C++ packer
   (g++) and the fold kernel (nvcc) built side by side, with the
   compiler's register/spill report and the kernel's launch as the
   occupancy query gives it (blocks and documents per SM) at the pinned
   shape and at the long-tail shape;
1. kernel vs plain, hard semantics — the committed fixture
   (``testing/hard_mergetree_docs.json``) folded by the CUDA kernel and by
   the plain PyTorch fold on the card: every slot of every plane, ``n``
   and ``overflow`` bit-equal, and the int32 exports byte-identical;
2. main path at full width — ``replay_mergetree_batch`` over the pinned
   workload (10,240 docs x 96 ops, one batch), the kernel's launch count
   read around it, a 256-document sample byte-identical to the CPU
   oracle, and kernel vs plain on that batch;
3. long tail — 32 documents of 1,536 ops (S = 3,072 slots), kernel vs
   plain and the kernel's time;
4. times — the kernel alone (CUDA events, median of 7), the plain fold
   once, the end-to-end rate with its stages, and the ``kernels`` line.

One JSON object per phase goes to stdout.  Any failure raises (non-zero
exit, no result line).  The last line is
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
DEVICE = "cuda"
KERNEL_SOURCE = "fluidframework_tpu_torch/csrc/mergetree_fold.cu"
TPU_KERNEL = "fluidframework_tpu/ops/pallas_fold.py:419"
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

def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def build_all():
    """g++ for the packer and nvcc for the kernel, started together."""
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
                    "mergetree_fold")))]
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


def export_diff(want, got):
    """Largest |difference| of two int32 exports over the whole buffer;
    0 only when the two are byte-identical."""
    import torch

    if want.shape != got.shape or want.dtype != got.dtype:
        raise AssertionError(f"exports differ in layout: {want.shape} "
                             f"{want.dtype} vs {got.shape} {got.dtype}")
    if torch.equal(want, got):
        return 0
    return max(1, int((want.long() - got.long()).abs().max()))


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
    err = max(err, export_diff(mt.export_state(want), mt.export_state(got)))
    if err:
        print(f"kernel vs plain: first mismatch (field, index, plain, "
              f"kernel) = {first}", file=sys.stderr)
    return err, start.elapsed_time(end), got


def time_kernel(state, ops, reps=7, spin=True):
    """The kernel's device time: median of ``reps`` launches, each timed
    with CUDA events behind a short device-side spin, so the events bound
    the kernel and not the host's time to enqueue it (the wrapper's
    checks and allocations).  ``spin=False`` times the whole call, the
    host's enqueue included wherever the device waits for it."""
    import torch

    from fluidframework_tpu_torch.ops import fold_cuda

    for _ in range(2):
        fold_cuda.fold(state, ops)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fold_cuda.fold(state, ops)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def fold_work(state, ops):
    """Integer operations the fold needs on these inputs, found by walking
    the op tail with the plain fold's own steps: for each real op row, one
    view and scan over the slots live at that row, the shift of the slots
    after each split or insert index only, the insert's own slot and
    decision, and the range tail over the slots the op stamps."""
    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mt

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
        live_slots += torch.where(real, m, 0).sum()
        st, n, overflow = mt._apply_op(st, n, overflow, slot, op)
    return int(total), int(live_slots)


def bound_ms(state, ops, D, S, T, K):
    """Least time for the fold at these inputs: the larger of the bytes it
    must move (state in + out, ops once) over HBM and the integer work
    these inputs need (``fold_work``) over the int32 rate."""
    state_bytes = D * ((12 + K) * S * 4 + 4 + 1)
    op_bytes = D * T * (9 + K) * 4
    moved = 2 * state_bytes + op_bytes
    kind = ops.kind
    real_rows = int(((kind >= 1) & (kind <= 4)).sum())
    int_ops, live_slots = fold_work(state, ops)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = int_ops / INT32_OPS_PER_S * 1e3
    return {
        "bytes": moved, "int_ops": int_ops, "bytes_ms": bytes_ms,
        "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "real_op_rows": real_rows,
        "mean_live_slots": live_slots / max(1, real_rows),
    }


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
    from fluidframework_tpu_torch.convert import (ops_from_numpy,
                                                  state_from_numpy)
    from fluidframework_tpu_torch.ops import _cuda_build, fold_cuda
    from fluidframework_tpu_torch.ops import mergetree_kernel as mt
    from fluidframework_tpu_torch.testing import workload

    t_run = time.perf_counter()
    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)

    # -- 0. card and build ------------------------------------------------
    built = build_all()
    occ = [fold_cuda.occupancy(PINNED_S, 1), fold_cuda.occupancy(TAIL_S, 1)]
    with open(_cuda_build.library_path("mergetree_fold") + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln
                 or "spill" in ln or "smem" in ln]
    emit({"phase": "build", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "seconds": {k: v[1] for k, v in built.items()},
          "ptxas": ptxas, "occupancy": occ})

    # -- 1. kernel vs plain on the hard-semantics fixture -----------------
    docs = workload.hard_docs()
    state_np, ops_np, _meta = mt.pack_mergetree_batch(docs)
    state = state_from_numpy(state_np, dev)
    ops = ops_from_numpy(ops_np, dev)
    err, _plain_ms, got = kernel_vs_plain(state, ops)
    parity = {"fixture": err}
    over = got.overflow.cpu().tolist()
    emit({"phase": "hard_semantics", "docs": [d.doc_id for d in docs],
          "shape": list(state_np.props.shape) + [ops_np.kind.shape[1]],
          "max_abs_err": err, "tolerance": 0, "overflow": over})
    if err != 0:
        raise AssertionError(f"kernel != plain fold on the fixture: {err}")
    if not over[-1]:
        raise AssertionError("the overflow document did not overflow")

    # -- 2. main path at full width ---------------------------------------
    t = time.perf_counter()
    docs = [workload.synth_doc(i, N_OPS) for i in range(N_DOCS)]
    synth_s = time.perf_counter() - t
    stats = {}
    fold_cuda.fold.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    summaries = mt.replay_mergetree_batch(docs, stats=stats, device=dev)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t
    launches = fold_cuda.fold.launches
    n_ops = N_DOCS * N_OPS
    if launches < 1:
        raise AssertionError("the main path did not launch the fold kernel")
    step = max(1, N_DOCS // ORACLE_SAMPLE)
    sample = list(range(0, N_DOCS, step))[:ORACLE_SAMPLE]
    t = time.perf_counter()
    mismatched = [docs[i].doc_id for i in sample
                  if summaries[i].digest()
                  != workload.oracle_replay(docs[i]).summarize().digest()]
    oracle_s = time.perf_counter() - t
    emit({"phase": "main_path", "docs": N_DOCS, "ops": n_ops,
          "launches": launches, "stats": stats,
          "oracle_sample": len(sample), "oracle_mismatches": mismatched,
          "synth_s": synth_s, "e2e_s": e2e_s,
          "oracle_sample_s": oracle_s})
    if mismatched:
        raise AssertionError(f"summaries differ from the oracle: "
                             f"{mismatched[:8]}")
    if len(summaries) != N_DOCS:
        raise AssertionError("summary count")

    # The same batch staged by hand: stage times, then kernel vs plain.
    t = time.perf_counter()
    state_np, ops_np, meta = mt.pack_mergetree_batch(docs)
    pack_s = time.perf_counter() - t
    D, S = state_np.tstart.shape
    T, K = ops_np.kind.shape[1], state_np.props.shape[2]
    torch.cuda.synchronize()
    t = time.perf_counter()
    ops = ops_from_numpy(ops_np, dev)
    state = mt.cold_start(ops, S)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t
    t = time.perf_counter()
    final = fold_cuda.fold(state, ops)
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t
    t = time.perf_counter()
    export = mt.export_state(final)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    export_np = export.cpu().numpy()
    download_s = time.perf_counter() - t
    t = time.perf_counter()
    staged = mt.summaries_from_export(meta, export_np)
    summaries_s = time.perf_counter() - t
    if [s.digest() for s in staged[:64]] != \
            [s.digest() for s in summaries[:64]]:
        raise AssertionError("staged run differs from the entry point")
    err, plain_ms, _ = kernel_vs_plain(state, ops)
    parity["main"] = err
    emit({"phase": "main_batch_parity", "shape": [D, S, T, K],
          "max_abs_err": err, "tolerance": 0, "plain_ms": plain_ms})
    if err != 0:
        raise AssertionError(f"kernel != plain fold on the main batch: {err}")
    if S != PINNED_S:
        raise AssertionError(f"the pinned batch packed to S={S}, "
                             f"not {PINNED_S}")

    # -- 3. long tail: S = 3,072 ------------------------------------------
    tail_docs = [workload.synth_doc(i, TAIL_OPS) for i in range(TAIL_DOCS)]
    tail_np, tail_ops_np, _meta = mt.pack_mergetree_batch(tail_docs)
    tail_ops = ops_from_numpy(tail_ops_np, dev)
    tail_state = state_from_numpy(tail_np, dev)
    if tail_np.tstart.shape[1] != TAIL_S:
        raise AssertionError(f"the long tail packed to "
                             f"S={tail_np.tstart.shape[1]}, not {TAIL_S}")
    tail_err, tail_plain_ms, _ = kernel_vs_plain(tail_state, tail_ops)
    parity["long_tail"] = tail_err
    tail_ms, tail_runs = time_kernel(tail_state, tail_ops)
    emit({"phase": "long_tail", "shape": list(tail_np.props.shape)
          + [tail_ops_np.kind.shape[1]], "max_abs_err": tail_err,
          "tolerance": 0, "kernel_ms": tail_ms, "kernel_runs_ms": tail_runs,
          "plain_ms": tail_plain_ms})
    if tail_err != 0:
        raise AssertionError(f"kernel != plain fold on the long tail: "
                             f"{tail_err}")

    # -- 4. times ----------------------------------------------------------
    ms, runs = time_kernel(state, ops)
    call_ms, _ = time_kernel(state, ops, spin=False)
    bound = bound_ms(state, ops, D, S, T, K)
    staged_s = pack_s + upload_s + fold_s + export_s + download_s \
        + summaries_s
    emit({"phase": "times", "card": card, "kernel_ms": ms,
          "kernel_runs_ms": runs, "kernel_call_ms": call_ms,
          "gap_to_bound": ms / bound["bound_ms"],
          "docs_per_sm": occ[0]["docs_per_sm"], "plain_ms": plain_ms,
          "bound": bound, "e2e_ops_per_s": n_ops / e2e_s,
          "stages_s": {"pack": pack_s, "upload": upload_s,
                       "fold": fold_s, "export": export_s,
                       "download": download_s, "summaries": summaries_s},
          "staged_ops_per_s": n_ops / staged_s,
          "run_s": time.perf_counter() - t_run})
    emit({"kernels": [{
        "name": "mergetree_fold", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches,
        "max_abs_err": max(parity.values()), "tolerance": 0,
        "parity": max(parity.values()) == 0,
        "max_abs_err_by_batch": parity, "ms": ms, "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "library_ms": None, "card": card}]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
