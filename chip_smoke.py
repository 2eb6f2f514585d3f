#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (built for an H100, sm_90a).

Run from the root of a checkout: ``python3 chip_smoke.py``.  It imports
only the port (``fluidframework_tpu_torch``), torch and numpy, builds the
port's libraries from the sources in the checkout, and runs in order:

0. card and build — the card's name and power limit, then the C++ packer
   (g++) and the kernel sources (nvcc: the merge-tree fold, the resident
   kernels, the tree fold, the map reduction and the matrix fold) built
   side by side, with
   the compiler's register/spill report and the launch each build of the
   merge-tree kernel takes (blocks and documents per SM) at the pinned,
   long-tail and large shapes, and the matrix fold's;
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
   phase's own resident buffers, and timed;
8. SharedTree catch-up at full width (``tree_phase``, after the
   reference's ``run_tree_rebase``): the pinned tree workload (10,240
   documents x 48 edits, five shapes) through ``pipelined_tree_replay``
   cold, exact and grown with the three cache tiers on, the same windows
   with them off, and ``replay_tree_batch``: every pass equal to its twin,
   an oracle sample of every shape byte-identical, the byte counters and
   per-reason fallback counts equal to the JAX package's for the same
   workload, the exact pass moving nothing up and the digest plane down,
   the splice on the grown pass (one launch a chunk for its three row
   axes), the resident entries equal to the grown chunks' planes, and the
   splice held against its plain version along the tree's three row axes,
   and in one launch; both builds of the tree kernel
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
   ``replay_matrix_batch`` over 10,240 x ``gen_matrix_doc(i, 64)`` (a
   cold batch: no state up), one launch of the matrix fold
   (``csrc/matrix_fold.cu``) in shared memory, every summary equal to the
   oracle's, the stage split, the transfer bytes and the rate; the
   fixture's routing counts equal to the JAX package's; the fold held
   against the plain fold, every plane and resolved handle, cold and
   warm, on the main batch, the fixture, the crafted resolve cases and 16
   documents of 2,048 ops (S = 4,096, one launch in shared memory through
   the entry too); a violated fact (an obliterate row, a props write, an
   obliterate stamp) counted and raised; both batches timed;
11. the catch-up service seam (``service_phase``): one
   ``CatchupService(service, device=...)`` call routing every channel of
   every document into its family on the card, behind the tier-1 result
   cache.  S1 the pinned workload as a service corpus (10,240 x 96,
   cold: wall, ops/s, stage dict, bytes, stats deltas, the service's host
   steps timed apart, a 256-document sample equal to the CPU container
   fold); S2 the same call again (pure tier-1: hit rate 1.0, no bytes, no
   launch); the device busy share of a cold pass traced under the
   ``Catchup.ProfileDir`` gate; S3 phase 7's windows without tier 1
   (cold, exact, every 8th grown; bytes beside phase 7's; equal to a
   tiers-off instance); S4 the tree corpus (2,048 x 48, cold and tier-1
   warm); S5 64 mixed documents (string, map, matrix, tree, counter; a
   cold and a warm round equal to the forced container fold, K7 and K4
   once a round); S6 1,024 attribution documents whose window clamps
   their inserts, every summary equal to the container fold;
12. the network ordering server (``server_phase``): the port's
   ``OrderingServer`` on a thread, its catch-up service and streaming
   fold on the card, reached over TCP by the port's own client.  R1 one
   ``catchup`` RPC for S1's corpus (10,240 x 96, cold: wall, ops/s,
   ``deviceDocs``, admission counters, the time inside the seam and
   beyond it, a 256-document sample equal to the CPU container fold);
   R2 the same RPC (the warm lane: no launch, no bytes); R3 live
   ``Loader`` sessions over the mixed datastore typing over TCP, folded
   by one RPC (K1, K5, K7, K4) and loaded fresh with nothing to replay;
   R4 the streaming fold at the gates' defaults over the 10,240
   documents (a forced ``stream_poll``, rounds of 8 committed ops each
   folded by one ``stream_poll``, one more round traced for the device
   busy share, a ``catchup`` within the cadence served by the stream
   lane, one past it folded at the head); R5 the standalone server
   (``python -m fluidframework_tpu_torch.service.server --device cuda
   --dir ...``) in a subprocess, its document surviving a restart;
13. the doc-sharded fold (``mesh_phase``): ``parallel/shard.py`` on
   device lists that name the card twice and three times (the second
   pads): M1 the pinned workload, M2 S4's 2,048 trees, M3 / M4 the map
   and matrix main batches, each equal to its one-device entry and
   launching its kernel once a part; M5 phase 7's windows through the
   doc-sharded tiers (bytes beside phase 7's, K6 once a part on the grown
   pass); M6 ``CatchupService(mesh=...)`` over S1's first 2,048
   documents, equal to S1;
14. the out-of-process tier (``frontdoor_phase``): a ``FrontDoor`` over
   two shard processes on the card, heartbeats on: F1 512 documents
   written through the door and one ``catchup`` RPC a shard (``cpuDocs``
   0, equal to this process's fold of the logs read back), F3 eight
   documents live-migrated byte-identically, F2 a shard SIGKILLed
   mid-traffic then a catch-up on the new owner, F4 the per-shard
   ``stats`` RPC; shard start times, RSS and each step's launches in the
   shard processes;
15. the scenario engine (``scenarios_phase``, the port's
   ``testing.scenarios`` with ``device=``): W1 the catch-up storm
   (10,000 clients, 128 documents, 4 orderer shards) and its never-shed
   oracle twin, its storm verdict (the port's load-generator CLI's
   ``verdict``), and the same spec with ``device="cpu"`` (equal heads
   and sampled digests; K1 launched), then the same storm through the
   CLI's ``main`` (``--storm --device cuda``: its verdict passes, its
   storm counters equal the in-process run's); W2
   tree-collab at the same size with the fold probe (warm pass served
   resident, K5 launched, equal to the ``device="cpu"`` run); W3 the
   storm against 2 shard processes on the card (equal to its in-process
   twin; K1 launched in the shard processes);
16. the wire soak (``soak_phase``): 1,024 mixed-channel documents seeded
   over TCP by 4 subprocesses into an in-process ``OrderingServer`` on
   the card, one ``catchup`` RPC over all of them (K1, K5, K7 and K4
   launched, ``deviceDocs`` all but none), sampled fresh loads equal to
   the seeders' digests;
17. BASELINE.json config #3, SharedString with interval collections
   (``interval_phase``): I1 2,048 x ``gen_interval_doc(i, 96)`` through
   both entries (equal, an oracle sample with the ``intervals`` blob, no
   fallback, bytes equal to the layout's); I2 the stabbing workload at
   10,240 documents through the five passes of the reference's
   ``run_interval_stabbing`` with the three tiers (cold, traced for the
   device busy share; exact; every 8th grown; tiers off;
   post-invalidation), each pass equal to its twin, bytes equal to the
   layout's and printed beside the JAX package's CPU counters, an oracle
   sample of the grown windows, K1 and K6 counted; I3 interval fuzz logs
   cold and from a base with an ``intervals`` blob, and logs mixing
   obliterates (the oracle route), on the card against ``device="cpu"``
   and the oracle; I4 1,024 interval containers through one
   ``CatchupService`` call, equal to a ``device="cpu"`` fold;
18. times — each build of the fold kernel alone (CUDA events behind a
   device spin, median of 7; and the whole call), its plain version once,
   its bound, and the ``kernels`` line (the four fold builds, the two
   resident kernels, the two tree builds, the matrix fold at both shapes
   and the map kernel; the tree, map and matrix
   rows their ``launch_shape``, the tree rows the walk steps and the
   longest document's edit rows plus walk steps, the matrix rows the
   bound of the work the cold design must do, ``design_bound_ms``).

Each driven path (the one-batch entry, the state path, the large-S
paths, the pipeline, each warm pass, each tree pass, the map and matrix
entries, each service call, each server RPC, each mesh path, each
scenario run, the soak's RPC, each interval run) runs with
every launch count set to 0 just before it and read just after; each
row of the ``kernels`` line also carries its launches on every service
call (``service_launches``), every server RPC (``server_launches``),
every mesh path (``mesh_launches``), every front-door step, counted
in the shard processes (``frontdoor_launches``), every scenario run
(``scenario_launches``; W3's shard processes as ``scenario_w3_shards``),
the soak's RPC (``soak_launches``) and every interval run
(``interval_launches``).  One JSON object per
phase goes to stdout.  Any failure raises (non-zero exit, no result
line).  The last line is
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
MATRIX_GMEM_DOCS, MATRIX_GMEM_OPS = 16, 2048  # S = 4,096
MAP_SOURCE = "fluidframework_tpu_torch/csrc/map_lww.cu"
MAP_REPLACES = "fluidframework_tpu/ops/map_kernel.py:140"
MATRIX_REPLACES = ("fluidframework_tpu/ops/matrix_kernel.py:70 "
                   "(+ _resolve_handle :58)")
MATRIX_SOURCE = "fluidframework_tpu_torch/csrc/matrix_fold.cu"
#: the entry points' rates are the median of this many calls (the driven
#: call and the ones after it)
ENTRY_CALLS = 3
#: the service phase (``CatchupService``, the product's catch-up seam):
#: S1 / S2 the pinned workload as a service corpus (bench.py
#: ``build_catchup_corpus``), cold then tier-1 warm, its oracle sample;
#: S3 the warm windows of phase 7 without tier 1; S4 the tree corpus at
#: the reference's ``run_tree_catchup_service`` size and its oracle
#: sample; S5 mixed five-channel documents, driven deep enough that each
#: map and matrix channel holds about the ops of a ``gen_matrix_doc``
#: document (a routing and parity check: 64 documents make no service
#: rate); S6 attribution documents
SVC_TREE_DOCS, SVC_TREE_SAMPLE = 2048, 64
SVC_MIXED_DOCS, SVC_MIXED_ROUNDS, SVC_MIXED_WARM_ROUNDS = 64, 320, 64
SVC_ATTR_DOCS = 1024
#: where the profiled S1 pass writes its trace (gitignored)
SVC_TRACE_DIR = os.path.join(REPO, "fluidframework_tpu_torch", "build",
                             "service_trace")
#: the server phase (``OrderingServer``, the deployed shape, over S1's
#: corpus): R3's live documents (two writers each over TCP) and their
#: edit rounds; R4's growth per stream round (the cadence of the
#: ``Catchup.StreamCadence`` gate's default), its clean rounds before the
#: profiled one, the stream lane's growth (within the cadence) and the
#: documents grown past it; R5's ops typed into the spawned server
SRV_LIVE_DOCS, SRV_LIVE_ROUNDS = 8, 48
SRV_GROW_OPS, SRV_STREAM_ROUNDS = 8, 2
SRV_LANE_OPS, SRV_PAST_DOCS = 2, 16
SRV_R5_OPS = 96
#: one RPC's bound, seconds (a cold fold of S1's corpus takes ~10 s)
SRV_RPC_TIMEOUT = 600.0
#: where the profiled stream round writes its trace, and R5's --dir
#: (both gitignored)
SRV_TRACE_DIR = os.path.join(REPO, "fluidframework_tpu_torch", "build",
                             "server_trace")
SRV_R5_DIR = os.path.join(REPO, "fluidframework_tpu_torch", "build",
                          "server_r5")
#: the mesh phase: device lists that name the one card twice and three
#: times (the second pads every batch), its tree corpus (S4's streams:
#: ``synth_tree_messages``) and the tree oracle sample (every shape)
MESH_LISTS = {"x2": ["cuda:0", "cuda:0"], "x3": ["cuda:0"] * 3}
MESH_TREE_DOCS, MESH_TREE_EDITS, MESH_TREE_SAMPLE = 2048, 48, 32
#: M6's depth: the first documents of S1's corpus (cut from all 10,240 so
#: that the smoke keeps its time with the interval phase added)
MESH_SEAM_DOCS = 2048
#: the frontdoor phase: shard processes, documents written through the
#: door (S1's streams), the ops each grows by in F2, the documents F3
#: migrates, the heartbeat interval, one RPC's bound, the container-fold
#: sample, and where the deployment directory goes (gitignored)
#: (F1's depth cut from 1,024 documents so that the smoke keeps its time
#: with the interval phase added)
FD_SHARDS, FD_DOCS, FD_GROW_OPS, FD_MIGRATE = 2, 512, 16, 8
FD_HEARTBEAT, FD_RPC_TIMEOUT, FD_ORACLE_SAMPLE = 1.0, 600.0, 64
FD_BATCH_DOCS = 64
FD_DIR = os.path.join(REPO, "fluidframework_tpu_torch", "build",
                      "frontdoor")
#: the scenarios phase (the port's ``testing.scenarios`` on the card): W1
#: the catch-up storm and W2 tree-collab (with the fold probe) at the
#: settings of the JAX package's BENCH_catchup_storm_cpu_r15.json (seed,
#: clients, documents, shards); W3 the storm out of process, its shards
#: folding in shard processes on the card, at the size of the
#: process-tier swarm smoke (tests/test_fluidproc.py), and where its
#: deployment goes (gitignored); the storm's gate is the port's
#: load-generator CLI's (``tools.loadgen.verdict``)
SCN_SEED, SCN_CLIENTS, SCN_DOCS, SCN_SHARDS = 10, 10_000, 128, 4
W3_SEED, W3_CLIENTS, W3_DOCS, W3_SHARDS = 12, 1_000, 16, 2
SCN_DIR = os.path.join(REPO, "fluidframework_tpu_torch", "build",
                       "scenarios")
#: the soak phase (the wire soak of tests/test_tools_and_load.py at its
#: size): documents, and the bound of the seeding and of the one
#: ``catchup`` RPC
SOAK_DOCS = 1024
SOAK_TIMEOUT = 600.0
#: the interval phase (BASELINE.json config #3, SharedString with
#: interval collections): I1 ``gen_interval_doc`` at the reference's size
#: (tools/bench_configs.py: 2,048 x 96); I2 the stabbing workload
#: (tools/bench_kernels.py ``run_interval_stabbing``: 10,240 documents,
#: base windows of IV_OPS - IV_OPS // 8 ops, every GROW_EVERY-th grown to
#: IV_OPS) and the JAX package's CPU counters for it; I3 interval fuzz
#: logs (as tests/torch_corpora.interval_docs), IV_FUZZ_DOCS seeds each
#: plain and with obliterates; I4 interval containers behind the seam,
#: their base summaries uploaded after IV_SEAM_BASE ops; the oracle
#: sample (every IV_ORACLE_EVERY-th document) and where the cold pass's
#: trace goes (gitignored)
IV_CFG_DOCS, IV_CFG_OPS = 2048, 96
IV_DOCS, IV_OPS = 10240, 96
IV_REFERENCE = "BENCH_kernels_cpu_r14.json"
IV_FUZZ_DOCS = 32
IV_SEAM_DOCS, IV_SEAM_BASE = 1024, 48
IV_ORACLE_EVERY = 16
IV_TRACE_DIR = os.path.join(REPO, "fluidframework_tpu_torch", "build",
                            "interval_trace")
#: the launch counters of each row of the ``kernels`` line (the service
#: and server paths' launches are summed over them)
ROW_COUNTS = {
    "mergetree_fold_smem": ("fold_smem",),
    "mergetree_fold_gmem": ("fold_gmem",),
    "mergetree_fold_export_smem": ("fold_export_smem",),
    "mergetree_fold_export_gmem": ("fold_export_gmem",),
    "splice_rows": ("splice_rows",),
    "widen_resident": ("widen_resident",),
    "tree_fold": ("tree_fold_smem", "tree_fold_gmem"),
    "tree_fold_digest": ("tree_fold_digest_smem", "tree_fold_digest_gmem"),
    "matrix_fold": ("matrix_fold_smem", "matrix_fold_gmem"),
    # the large-S row shares K4's counters; its service launches are
    # counted once, on the row above
    "matrix_fold_large_s": (),
    "map_lww": ("map_lww",),
}
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
#: each later phase's main batch, its one-device summaries' digests (and
#: stats), kept for the ``mesh`` phase to hold the sharded paths against:
#: "map" / "matrix" (the phases 9 and 10 batches), "warm" (phase 7's
#: windows and their one-batch digests)
MAIN_BATCHES = {}


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
                "map_lww", lambda: _cuda_build.build("map_lww"))),
            threading.Thread(target=run, args=(
                "matrix_fold", lambda: _cuda_build.build("matrix_fold")))]
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


def transfer_row_bytes(meta, S):
    """(h2d bytes of one op row as it is uploaded, d2h bytes of one
    document's export) of a packed chunk: the narrow dtypes when
    ``i16_ok`` holds (else int32), ``pvals`` once a props key; the export's
    ``export_layout_rows`` rows of S slots (int16 when ``i16_ok``) plus the
    [4] int32 misc leaf of an i8 layout."""
    import numpy as np

    from fluidframework_tpu_torch.ops import mergetree_kernel as mt

    i16, _ob, _ov, i8, _props = mt._export_flags(meta)
    size = {f: np.dtype(mt._UPLOAD_NARROW_DTYPES[f]).itemsize if i16
            else 4 for f in mt.MTOps._fields}
    row = sum(size[f] for f in mt.OP_FIELDS) \
        + meta["props_K"] * size["pvals"]
    doc = mt.export_layout_rows(meta) * S * (2 if i16 else 4) \
        + (4 * 4 if i8 else 0)
    return row, doc


def expected_transfer(packed, tiers=False):
    """(h2d, d2h) bytes of a pipelined run worked out from each chunk's
    layout facts (cold chunks): the op stream in the narrow dtypes when
    ``i16_ok`` holds (else int32), and the transfer buffer of
    ``export_layout_rows`` rows (int16 when ``i16_ok``, plus the [D, 4]
    int32 misc leaf for i8 layouts).  With the cache ``tiers`` on, a
    chunk's first fold also uploads its int32 ``doc_base`` (the resident
    entry's aux) and downloads the [D, 2] digest plane."""
    h2d = d2h = 0
    for state, ops, meta, S in packed:
        if state is not None:
            raise AssertionError("expected_transfer counts cold chunks")
        D, T = ops.kind.shape
        row, doc = transfer_row_bytes(meta, S)
        h2d += D * T * row + (D * 4 if tiers else 0)
        d2h += D * doc + (D * 8 if tiers else 0)
    return h2d, d2h


def expected_grown_transfer(cold_packed, grown_packed, changed, on_card):
    """(h2d, d2h) bytes of a grown pass over resident chunks, worked out
    from the layout: per chunk, the suffix splice's upload (each
    document's new op rows, ``next_bucket_fine`` of the longest suffix and
    at least 8, in the chunk's upload dtypes, plus the int32 ``t_old`` and
    count vectors; the full op stream and ``doc_base`` when the bucket
    reaches the chunk's width); down, the digest plane and the export rows
    of the ``changed[c]`` documents tier 0 cannot serve, padded on the
    card to ``next_bucket_fine(m, 8)`` (the whole chunk when that reaches
    it)."""
    import numpy as np

    from fluidframework_tpu_torch.ops.interning import next_bucket_fine

    h2d = d2h = 0
    for (_s0, cold_ops, _m0, _S0), (_s, ops, meta, S), m in zip(
            cold_packed, grown_packed, changed, strict=True):
        D, T = ops.kind.shape
        row, doc = transfer_row_bytes(meta, S)
        t_old = np.count_nonzero(np.asarray(cold_ops.kind), axis=1)
        t_new = np.count_nonzero(np.asarray(ops.kind), axis=1)
        L = min(next_bucket_fine(max(int((t_new - t_old).max()), 1),
                                 floor=8), T)
        h2d += D * L * row + 2 * D * 4 if L < T else D * T * row + D * 4
        pad = min(next_bucket_fine(m, floor=8), D) if on_card and m else m
        d2h += D * 8 + pad * doc
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
    from fluidframework_tpu_torch.ops.launches import reset_launches

    reset_launches()


def read_counts():
    """Launches of each build of the fold kernel, of the matrix fold, of
    each resident kernel, of each build of the tree kernel and of the map
    kernel since ``reset_counts`` (``ops.launches.launch_counts``)."""
    from fluidframework_tpu_torch.ops.launches import launch_counts

    return launch_counts()


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
    two resident kernels' rows of the ``kernels`` line and the passes'
    records (the service phase compares its bytes with them)."""
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
    MAIN_BATCHES["warm"] = (windows, want)
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
        got = resident_cuda.widen_resident(narrow, e.base)
        widen_err = max(widen_err, tree_diff(mt._widen_ops(narrow, e.base),
                                             got))
    if widen_err:
        raise AssertionError(f"widen_resident != plain ({widen_err})")
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
        raise AssertionError(f"splice_rows != plain ({splice_err})")
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
                w_plain_ms, w_bound)], passes


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
    (what the path's splices built); then, along the three axes (8 edit
    planes ``[D, T]``, 7 node planes ``[D, N]``, 2 container planes
    ``[D, C]``), the suffix rows past the cold chunk's counts are spliced
    into copies of the grown planes whose every element from each
    document's old count on is bit-flipped: by the kernel with every axis
    in one launch as the path does it (``splice_row_groups``), by the
    kernel an axis a launch, and by the plain version.  All must agree,
    restore exactly the rows [old, new) and leave the rows from new on
    flipped, and the chunks spliced must be as many as the
    ``path_splices`` launches the grown pass made (one a chunk).  Returns,
    per axis, the largest difference, the cases and rows checked, and one
    case timed, and the one-launch splice of a chunk's three axes
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

    def copy(planes):
        return type(planes)(*(x.clone() for x in planes))

    cold_by = {tokens(m): (o, m) for _s, o, m, _t in cold_packed}
    axes = (("edits", tk.TreeEdits), ("nodes", tp._TreeNodePlanes),
            ("containers", tp._TreeContPlanes))
    out = {axis: {"max_abs_err": 0, "cases": 0, "rows": 0}
           for axis, _g in axes}
    mirror_err, timed, chunks, grouped = 0, {}, 0, None
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
        cases = []
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
            cases.append((axis, full, rows, start, count, L,
                          int((new - old).sum())))
        if not cases:
            continue
        chunks += 1
        unspliced = {c[0]: flipped_from(c[1], c[3]) for c in cases}
        together = {axis: copy(x) for axis, x in unspliced.items()}
        resident_cuda.splice_row_groups(
            [(together[axis], rows, start, count)
             for axis, _f, rows, start, count, _L, _n in cases])
        if grouped is None:
            grouped = ([(copy(together[axis]), rows, start, count)
                        for axis, _f, rows, start, count, _L, _n in cases],
                       [axis for axis, *_rest in cases])
        for axis, full, rows, start, count, L, n_rows in cases:
            kernel, plain = (copy(unspliced[axis]) for _ in range(2))
            resident_cuda.splice_rows(kernel, rows, start, count)
            resident_cuda.splice_rows_reference(plain, rows, start, count)
            if not tree_diff(unspliced[axis], kernel):
                raise AssertionError(f"splice_rows wrote no {axis} row of "
                                     f"the suffix")
            rec = out[axis]
            restored = flipped_from(full, start + count)
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     tree_diff(plain, kernel),
                                     tree_diff(plain, together[axis]),
                                     tree_diff(restored, kernel))
            rec["cases"] += 1
            rec["rows"] += n_rows
            rec.setdefault("shape", [*full[0].shape, L])
            timed.setdefault(axis, (kernel, plain, rows, start, count,
                                    n_rows))
    if mirror_err:
        raise AssertionError(f"resident tree entries differ from the grown "
                             f"chunks' host planes: {mirror_err}")
    if chunks != path_splices:
        raise AssertionError(f"{chunks} tree chunks spliced, but the grown "
                             f"pass launched {path_splices} splices")
    for axis, rec in out.items():
        if not rec["cases"]:
            raise AssertionError(f"no grown tree chunk spliced {axis} rows")
        if rec["max_abs_err"]:
            raise AssertionError(f"splice_rows != plain along the tree's "
                                 f"{axis} axis: {rec}")
        kernel, plain, rows, start, count, n_rows = timed[axis]
        rec["ms"], rec["runs_ms"] = time_call(
            lambda: resident_cuda.splice_rows(kernel, rows, start, count))
        _x, rec["plain_ms"] = timed_once(
            lambda: resident_cuda.splice_rows_reference(plain, rows, start,
                                                        count))
        rec["bound"] = bytes_bound(
            2 * n_rows * 4 * len(kernel) + nbytes((start, count)),
            n_rows * len(kernel))
    groups, names = grouped
    ms, runs = time_call(lambda: resident_cuda.splice_row_groups(groups))
    out["one_launch"] = {"axes": names, "ms": ms, "runs_ms": runs,
                         "chunks": chunks}
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
    # the slowest document's chain: its real edit rows and walk steps
    longest = int((((ed.kind >= 1) & (ed.kind <= 4)).sum(1)
                   + work["doc_walk_steps"]).max())
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
        where = tree_fold_cuda.placement(N, C)
        rows[name] = {
            "name": name, "route": "cuda", "source": TREE_SOURCE,
            "replaces": TREE_DIGEST_REPLACES if name == "tree_fold_digest"
            else TREE_REPLACES,
            "placement": where,
            "launch_shape": tree_fold_cuda.launch_shape(D, N, C),
            "launches": launches[path][build], "path": path,
            "timed_shape": [D, N, C, T],
            "max_abs_err": err_digest if name == "tree_fold_digest"
            else err_fold, "tolerance": 0, "ms": ms, "runs_ms": runs,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "bound": bound, "real_edit_rows": real_rows,
            "walk_steps": work["walk_steps"],
            "longest_doc_rows_plus_walk": longest, "library_ms": None,
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
    MAIN_BATCHES["map"] = (docs, [g.digest() for g in got], dict(stats))
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
                       "gathers)",
            "launch_shape": map_lww_cuda.launch_shape(N, G, M,
                                                      batch.num_docs),
            "card": card}


def matrix_phase(dev, drive, launches, card):
    """Phase 10: SharedMatrix catch-up at full width (BASELINE.json config
    #4, the reference's ``gen_matrix_doc`` workload):
    ``replay_matrix_batch`` over 10,240 documents x 64 ops (20,480 axis
    streams, a cold batch) on the card, with one launch of the resolving
    fold (K4, ``csrc/matrix_fold.cu``) in shared memory and every summary
    byte-identical to the port's ``SharedMatrix`` oracle; its transfer
    bytes beside what the earlier entry moved (every plane up and down);
    the same batch staged by hand and the entry's rate (median of 3
    calls); the committed fixture through the entry (summaries against
    the oracle, routing counts equal to the JAX package's); K4 against the
    plain ``replay_scan_resolving`` on the card, every plane, ``n``,
    ``overflow`` and resolved handle, cold (no state read) and warm, on
    the main batch, the fixture, the crafted resolve cases and 16
    documents of 2,048 ops (S = 4,096, which the entry folds in shared
    memory too); a violated fact counted and raised; K4 timed on both
    batches.  Returns K4's rows of the ``kernels`` line."""
    import torch

    from fluidframework_tpu_torch.convert import tensors_to
    from fluidframework_tpu_torch.ops import matrix_fold_cuda as mf
    from fluidframework_tpu_torch.ops import matrix_kernel as mk
    from fluidframework_tpu_torch.testing import config_workloads as cw

    t = time.perf_counter()
    docs = [cw.gen_matrix_doc(i, MATRIX_OPS) for i in range(MATRIX_DOCS)]
    gen_s = time.perf_counter() - t
    n_ops = sum(len(d.ops) for d in docs)
    stats, transfer = {}, {}
    got, e2e_s = drive("matrix", lambda: mk.replay_matrix_batch(
        docs, stats=stats, device=dev, stage=transfer))
    MAIN_BATCHES["matrix"] = (docs, [g.digest() for g in got], dict(stats))
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
    D2, S = st_np.tstart.shape
    T = ops_np.kind.shape[1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    state_d, ops_d, h2d = mk.upload_matrix_batch(st_np, ops_np, meta, dev)
    torch.cuda.synchronize()
    stages["upload"] = time.perf_counter() - t
    t = time.perf_counter()
    final, resolved, viol = mf.fold_resolving(state_d, ops_d,
                                              cold=meta["cold"], S=S)
    torch.cuda.synchronize()
    stages["kernel"] = time.perf_counter() - t
    t = time.perf_counter()
    state_h, resolved_h, d2h = mk.download_matrix_fold(final, resolved,
                                                       viol)
    stages["download"] = time.perf_counter() - t
    t = time.perf_counter()
    staged = [mk.summary_from_matrix_state(meta, state_h, resolved_h, d)
              for d in range(len(docs))]
    stages["summaries"] = time.perf_counter() - t
    staged_same = [x.digest() for x in staged] == [x.digest() for x in got]
    # what the earlier entry moved: the whole state up, every plane down
    earlier_transfer = {
        "h2d_bytes": nbytes(tuple(st_np)) + nbytes(tuple(ops_np)),
        "d2h_bytes": nbytes(tuple(final)) + nbytes(resolved)}

    parity, plain_ms, inputs = {}, {}, {}

    def check(label, packed):
        """K4 cold (when the batch is) and warm against the plain fold on
        the same inputs."""
        s_np, o_np, m = packed
        st, op = tensors_to(s_np, dev), tensors_to(o_np, dev)
        (want_f, want_r), plain_ms[label] = timed_once(
            lambda: mk.replay_scan_resolving(st, op))
        for warmth in ("cold", "warm") if m["cold"] else ("warm",):
            cold = warmth == "cold"
            got_f, got_r, counted = mf.fold_resolving(
                None if cold else st, op, cold=cold, S=st.tstart.shape[1])
            torch.cuda.synchronize()
            mf.check_facts(counted)
            err_f, first = state_diff(want_f, got_f)
            parity[f"{label}_{warmth}"] = {
                "plain": max(err_f, leaves_diff(want_r, got_r))}
            if err_f:
                print(f"K4 vs plain ({label}, {warmth}): first state "
                      f"mismatch {first}", file=sys.stderr)
        inputs[label] = (st, op)

    check("main", (st_np, ops_np, meta))
    fixture = cw.hard_matrix_docs()
    check("fixture", mk.pack_matrix_batch(
        [d for d in fixture if not mk.known_matrix_fallback(d)]))
    check("crafted", mk.pack_matrix_batch(
        [cw.crafted_matrix_doc(c) for c in cw.CRAFTED_MATRIX]))
    fx_stats = {}
    fx_got = mk.replay_matrix_batch(fixture, stats=fx_stats, device=dev)
    fx_bad = [d.doc_id for d, g in zip(fixture, fx_got)
              if g.digest() != mk.oracle_matrix_fallback(d).digest()]

    # a violated fact is counted and raised, never answered
    f_st, f_op = inputs["fixture"]
    live = int(torch.nonzero(f_st.n)[0, 0])
    facts = {}
    for fact, (st, op) in {
            "obliterate_row": (f_st, f_op._replace(kind=torch.where(
                f_op.kind == mk.K_REMOVE, 4, f_op.kind))),
            "props_write": (f_st, f_op._replace(
                pvals=torch.zeros_like(f_op.pvals))),
            "ob_stamp": (f_st._replace(ob1_seq=f_st.ob1_seq.index_put(
                (torch.tensor([live], device=dev),
                 torch.tensor([0], device=dev)),
                torch.tensor(7, dtype=torch.int32, device=dev))), f_op),
    }.items():
        try:  # on the card the kernel counts it and check_facts raises
            mf.check_facts(mf.fold_resolving(st, op)[2])
            facts[fact] = False
        except ValueError:
            facts[fact] = True

    t = time.perf_counter()
    g_docs = [cw.gen_matrix_doc(i, MATRIX_GMEM_OPS)
              for i in range(MATRIX_GMEM_DOCS)]
    g_packed = mk.pack_matrix_batch(g_docs)
    g_pack_s = time.perf_counter() - t
    gD2, gS = g_packed[0].tstart.shape
    gT = g_packed[1].kind.shape[1]
    g_stats, g_transfer = {}, {}
    g_got, g_e2e_s = drive("matrix_large", lambda: mk.replay_matrix_batch(
        g_docs, stats=g_stats, device=dev, stage=g_transfer))
    check("large_s", g_packed)
    t = time.perf_counter()
    g_bad = [d.doc_id for d, g in zip(g_docs[:2], g_got)
             if g.digest() != mk.oracle_matrix_fallback(d).digest()]
    g_oracle_s = time.perf_counter() - t

    times = {}
    for label, shape in (("main", (D2, S, T)), ("large_s", (gD2, gS, gT))):
        st, op = inputs[label]
        d2, s_, t_ = shape
        cold_fn = lambda st=st, op=op, s_=s_: mf.fold_resolving(  # noqa
            None, op, cold=True, S=s_)
        warm_fn = lambda st=st, op=op: mf.fold_resolving(st, op)  # noqa
        k_ms, k_runs = time_call(cold_fn)
        w_ms, w_runs = time_call(warm_fn)
        k_call_ms, _ = time_call(cold_fn, spin=False)
        # the row's bound formula (state in and out, as for every build)
        # and the work this design must do cold (ops read, 9 planes and
        # the handles written, no state read)
        bound = bound_ms(st, op, state_out_bytes(d2, s_, t_, 1) + d2 * t_ * 4)
        design = bound_ms(st, op, d2 * t_ * 9 * 4 + d2 * s_ * 9 * 4
                          + d2 * (4 + 1 + 4) + d2 * t_ * 4)
        times[label] = {"shape": [d2, s_, t_, 1], "ms": k_ms,
                        "runs_ms": k_runs, "warm_ms": w_ms,
                        "warm_runs_ms": w_runs, "call_ms": k_call_ms,
                        "plain_ms": plain_ms[label], "bound": bound,
                        "design_bound": design,
                        "launch_shape": mf.occupancy(s_),
                        "resolve_rows": int((op.kind == mk.K_RESOLVE).sum())}
    k4 = {"main": launches["matrix"]["matrix_fold_smem"],
          "large_s": launches["matrix_large"]["matrix_fold_smem"]}
    emit({"phase": "matrix", "docs": MATRIX_DOCS, "ops": n_ops,
          "shape": [D2, S, T, 1], "cold": meta["cold"],
          "launches": launches["matrix"], "stats": stats,
          "oracle_docs": len(docs), "oracle_mismatches": bad[:8],
          "gen_s": gen_s, "oracle_s": oracle_s, "e2e_s": e2e_s,
          "walls_s": walls, "ops_per_s": n_ops / statistics.median(walls),
          "stages_s": stages, "staged_equals_entry": staged_same,
          "transfer": transfer, "staged_transfer": {"h2d_bytes": h2d,
                                                    "d2h_bytes": d2h},
          "earlier_transfer": earlier_transfer,
          "fixture": {"docs": len(fixture), "stats": fx_stats,
                      "reference_stats": MATRIX_FIXTURE_STATS,
                      "oracle_mismatches": fx_bad},
          "large_s": {"docs": MATRIX_GMEM_DOCS, "ops": MATRIX_GMEM_OPS,
                      "shape": [gD2, gS, gT, 1],
                      "placement": mf.placement(gS), "pack_s": g_pack_s,
                      "e2e_s": g_e2e_s, "stats": g_stats,
                      "transfer": g_transfer,
                      "launches": launches["matrix_large"],
                      "oracle_docs": 2, "oracle_mismatches": g_bad,
                      "oracle_s": g_oracle_s},
          "facts_raise": facts, "max_abs_err_by_batch": parity,
          "times": times})
    for label, path in (("main", "matrix"), ("large_s", "matrix_large")):
        if k4[label] != 1 or sum(launches[path].values()) != 1:
            raise AssertionError(f"replay_matrix_batch ({label}) did not "
                                 f"launch K4 once in shared memory: "
                                 f"{launches[path]}")
    if stats != {"device_docs": MATRIX_DOCS}:
        raise AssertionError(f"matrix stats {stats}")
    if bad or fx_bad or g_bad:
        raise AssertionError(f"matrix summaries differ from the oracle: "
                             f"{(bad + fx_bad + g_bad)[:8]}")
    if not staged_same or transfer != {"h2d_bytes": h2d, "d2h_bytes": d2h}:
        raise AssertionError(f"the staged matrix batch differs from the "
                             f"entry ({staged_same}, {transfer} vs "
                             f"{h2d} / {d2h})")
    if fx_stats != MATRIX_FIXTURE_STATS:
        raise AssertionError(f"fixture routing {fx_stats}, the JAX "
                             f"package's {MATRIX_FIXTURE_STATS}")
    if not all(facts.values()):
        raise AssertionError(f"a violated matrix fact did not raise: {facts}")
    err = max(max(v.values()) for v in parity.values())
    if err:
        raise AssertionError(f"K4 != plain: {parity}")
    rows = []
    for label, path in (("main", "matrix"), ("large_s", "matrix_large")):
        rec = times[label]
        by = {k: v for k, v in parity.items()
              if (label == "large_s") == k.startswith("large_s")}
        e = max(v["plain"] for v in by.values())
        rows.append({
            "name": "matrix_fold" if label == "main"
            else "matrix_fold_large_s", "route": "cuda",
            "source": MATRIX_SOURCE, "replaces": MATRIX_REPLACES,
            "placement": rec["launch_shape"]["placement"],
            "launch_shape": rec["launch_shape"], "launches": k4[label],
            "path": path, "timed_shape": rec["shape"], "max_abs_err": e,
            "tolerance": 0, "parity": e == 0, "max_abs_err_by_batch": by,
            "ms": rec["ms"], "runs_ms": rec["runs_ms"],
            "warm_ms": rec["warm_ms"], "call_ms": rec["call_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound"]["bound_ms"],
            "bound_by": rec["bound"]["bound_by"], "bound": rec["bound"],
            "design_bound_ms": rec["design_bound"]["bound_ms"],
            "design_bound": rec["design_bound"],
            "resolve_rows": rec["resolve_rows"], "library_ms": None,
            "library": "none: no one PyTorch call computes the axis fold "
                       "with resolution",
            "card": card})
    return rows


def trace_device_seconds(trace_dir):
    """Device time in the one ``torch.profiler`` Chrome trace under
    ``trace_dir``: seconds of CUDA kernels, memory copies and memsets
    (each event's duration summed), the span the trace covers, and the
    kernels that took the most time."""
    import glob

    files = sorted(glob.glob(os.path.join(trace_dir, "*.pt.trace.json")))
    if len(files) != 1:
        raise AssertionError(f"expected one trace in {trace_dir}: {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    total = {"kernel": 0.0, "gpu_memcpy": 0.0, "gpu_memset": 0.0}
    by_kernel = {}
    first, last = None, None
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        first = ts if first is None else min(first, ts)
        last = ts + dur if last is None else max(last, ts + dur)
        cat = e.get("cat")
        if cat in total:
            total[cat] += dur * 1e-6
            if cat == "kernel":
                by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) \
                    + dur * 1e-6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"seconds": total, "span_s": (last - first) * 1e-6
            if first is not None else 0.0,
            "top_kernels_s": top, "trace": os.path.relpath(files[0], REPO),
            "trace_bytes": os.path.getsize(files[0])}


def service_phase(dev, drive, launches, warm_passes):
    """Phase 11: the product's catch-up seam on the card.  One
    ``CatchupService(service, device=dev)`` call turns an op-log read into
    a decode, a device plan, per-type routing of every channel into its
    family's entry (K1 through ``pipelined_mergetree_replay``, K5 through
    ``pipelined_tree_replay``, K7 and K4 through the map and matrix
    entries, K6 on grown tails) and the container summaries' reassembly,
    behind the tier-1 result cache.  Sub-phases, each call a driven path:

    - S1: the pinned workload as a service corpus (10,240 x 96, cold):
      wall, ops/s, stage dict, bytes, stats deltas, a 256-document sample
      (first, middle, last) equal to the CPU container fold, and the
      service's host steps timed apart (the string replay, the rest of
      the device fold, the reads, plan and publish around it);
    - S2: the same call again: pure tier-1 (hit rate 1.0, no bytes, no
      launch);
    - the device busy share: one more cold pass on a fresh instance under
      the ``Catchup.ProfileDir`` gate, its trace's CUDA kernel time over
      the fold's wall;
    - S3: phase 7's windows without tier 1 (cold 80-op windows, the exact
      pass, every 8th document grown to 96 ops), each pass's bytes beside
      phase 7's, every pass equal to a tiers-off instance's;
    - S4: the tree corpus (2,048 x 48) cold and tier-1 warm, a sample
      equal to the container fold;
    - S5: 64 mixed documents (string, map, matrix, tree, counter), a cold
      and a warm round, every summary equal to the forced container fold,
      K7 and K4 once a round;
    - S6: 1,024 attribution documents whose window clamps their inserts,
      every summary equal to the container fold, with key blobs.

    Returns the service paths and S1's corpus (its service, doc ids and
    cold wall), which the server phase reuses."""
    import random
    import shutil

    import torch

    from fluidframework_tpu_torch.ops import pipeline as pl
    from fluidframework_tpu_torch.service import LocalOrderingService
    from fluidframework_tpu_torch.service.catchup import CatchupService
    from fluidframework_tpu_torch.testing import service_workload as sw
    from fluidframework_tpu_torch.utils.telemetry import (
        CollectingLogger, ConfigProvider, MonitoringContext)

    paths = []

    def call(path, svc, ids=None, **kw):
        """One catch-up as a driven path: results, wall, the call's stats
        deltas, and what it added to the stage dict and pipeline stats."""
        stats = {}
        stage0, pstats0 = dict(svc.pipeline_stage), dict(svc.pipeline_stats)
        res, wall = drive(path, lambda: svc.catch_up(ids, stats=stats, **kw))
        paths.append(path)
        stage = {k: v - stage0.get(k, 0)
                 for k, v in svc.pipeline_stage.items()}
        pstats = {k: v - pstats0.get(k, 0)
                  for k, v in svc.pipeline_stats.items()}
        return res, wall, stats, stage, pstats

    def launched(path, *rows):
        return sum(launches[path][k] for r in rows for k in ROW_COUNTS[r])

    def oracle_mismatches(service, res, doc_ids):
        t = time.perf_counter()
        bad = [d for d in doc_ids
               if res[d][0] != sw.catchup_oracle_digest(service, d)]
        return bad, time.perf_counter() - t

    def check(ok, what):
        if not ok:
            raise AssertionError(f"service: {what}")

    n_ops = N_DOCS * N_OPS
    no_fold = {"deviceDocs": 0, "cpuDocs": 0, "hostChannels": 0,
               "fallbackChannels": 0}

    # -- S1: cold, full width ------------------------------------------------
    t = time.perf_counter()
    service = LocalOrderingService()
    ids = sw.build_catchup_corpus(service, N_DOCS, N_OPS)
    build_s = time.perf_counter() - t
    svc = CatchupService(service, device=dev)
    timers = {"device_fold": 0.0, "string_replay": 0.0}

    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                timers[key] += time.perf_counter() - t0
        return run

    real_replay = pl.pipelined_mergetree_replay
    svc._device_fold = timed("device_fold", svc._device_fold)
    pl.pipelined_mergetree_replay = timed("string_replay", real_replay)
    try:
        res1, wall1, stats1, stage1, pstats1 = call(
            "service_s1_cold", svc, ids, upload=False)
    finally:
        pl.pipelined_mergetree_replay = real_replay
        del svc._device_fold
    picked = {0, N_DOCS // 2, N_DOCS - 1}
    for i in range(0, N_DOCS, max(1, N_DOCS // ORACLE_SAMPLE)):
        if len(picked) == ORACLE_SAMPLE:
            break
        picked.add(i)
    sample = [ids[i] for i in sorted(picked)]
    check(len(sample) == min(N_DOCS, ORACLE_SAMPLE), "S1 sample size")
    bad1, oracle1_s = oracle_mismatches(service, res1, sample)
    host_steps = {
        "catch_up_wall": wall1,
        "string_replay": timers["string_replay"],
        "device_fold_outside_replay":
            timers["device_fold"] - timers["string_replay"],
        "reads_plan_publish": wall1 - timers["device_fold"]}
    emit({"phase": "service_s1", "docs": N_DOCS, "ops": n_ops,
          "corpus_build_s": build_s, "wall_s": wall1,
          "ops_per_s": n_ops / wall1, "stats": stats1,
          "pipeline_stats": pstats1, "stage": stage1,
          "h2d_bytes": stage1["h2d_bytes"], "d2h_bytes": stage1["d2h_bytes"],
          "host_steps_s": host_steps, "launches": launches["service_s1_cold"],
          "oracle_sample": len(sample), "oracle_s": oracle1_s,
          "oracle_mismatches": bad1[:8]})
    check(stats1 == dict(no_fold, deviceDocs=N_DOCS), f"S1 stats {stats1}")
    check(len(res1) == N_DOCS and not bad1, f"S1 oracle {bad1[:8]}")
    check(launched("service_s1_cold", "mergetree_fold_export_smem") >= 1,
          f"S1 launched no fold+export: {launches['service_s1_cold']}")

    # -- S2: tier-1 warm -----------------------------------------------------
    hits0 = svc.cache.stats()["hits"]
    res2, wall2, stats2, stage2, _ = call("service_s2_warm", svc, ids,
                                          upload=False)
    hit_rate = (svc.cache.stats()["hits"] - hits0) / N_DOCS
    emit({"phase": "service_s2", "wall_s": wall2, "ops_per_s": n_ops / wall2,
          "hit_rate": hit_rate, "stats": stats2, "stage": stage2,
          "launches": launches["service_s2_warm"],
          "cache": svc.cache.stats()})
    check(res2 == res1 and hit_rate == 1.0 and stats2 == no_fold,
          f"S2 hit rate {hit_rate}, stats {stats2}")
    check(not any(stage2.values()), f"S2 moved or packed: {stage2}")
    check(not any(launches["service_s2_warm"].values()),
          f"S2 launched: {launches['service_s2_warm']}")
    del svc
    torch.cuda.empty_cache()

    # -- the device busy share of a cold S1 pass -----------------------------
    shutil.rmtree(SVC_TRACE_DIR, ignore_errors=True)
    log = CollectingLogger()
    prof = CatchupService(service, device=dev, mc=MonitoringContext(
        log, ConfigProvider({"Catchup.ProfileDir": SVC_TRACE_DIR})))
    res_p, wall_p, _stats, _stage, _ = call("service_s1_profiled", prof,
                                            ids, upload=False)
    check(res_p == res1, "the profiled pass differs from S1")
    fold_s = [e["durationMs"] for e in log.events
              if e["eventName"] == "catchup:bulkCatchup_end"][0] / 1e3
    trace = trace_device_seconds(SVC_TRACE_DIR)
    kernel_s = trace["seconds"]["kernel"]
    emit({"phase": "service_busy", "traced_wall_s": wall_p,
          "traced_fold_s": fold_s, "untraced_s1_wall_s": wall1,
          "device_busy_share": kernel_s / fold_s,
          "device_busy_share_with_copies":
              sum(trace["seconds"].values()) / fold_s,
          "kernel_s_over_untraced_wall": kernel_s / wall1, **trace})
    check(kernel_s > 0, "the trace holds no CUDA kernel time")
    # S1's corpus (still at its seeded summaries: every S1 call folded
    # with upload=False) is the server phase's
    s1 = {"service": service, "ids": ids, "wall_s": wall1,
          "digests": {d: res1[d][0] for d in ids}}
    del prof, service, res1, res2, res_p
    torch.cuda.empty_cache()

    # -- S3: tiers 0 / 2 / 2.5 without tier 1 --------------------------------
    t = time.perf_counter()
    service = LocalOrderingService()
    ids = sw.build_catchup_corpus(service, N_DOCS, WARM_BASE_OPS)
    build_s = time.perf_counter() - t
    svc = CatchupService(service, cache=None, device=dev)
    off = CatchupService(service, cache=None, pack_cache=None,
                         delta_cache=None, device_cache=None, device=dev)
    s3 = {}
    for name, inst in (("cold", svc), ("exact", svc), ("off_cold", off),
                       ("grow", None), ("grown", svc), ("off_grown", off)):
        if inst is None:
            grown = sw.grow_catchup_corpus(service, ids, WARM_BASE_OPS, N_OPS,
                                           grow_every=GROW_EVERY)
            continue
        res, wall, stats, stage, pstats = call(
            f"service_s3_{name}", inst, ids, upload=False)
        s3[name] = {"wall_s": wall, "stats": stats, "pipeline_stats": pstats,
                    "h2d_bytes": stage["h2d_bytes"],
                    "d2h_bytes": stage["d2h_bytes"], "stage": stage,
                    "launches": launches[f"service_s3_{name}"], "res": res}
    phase7 = {"cold": "cold", "exact": "exact", "grown": "grown",
              "off_grown": "grown_off"}
    bytes_vs_phase7 = {
        name: {"service": [s3[name]["h2d_bytes"], s3[name]["d2h_bytes"]],
               "phase7": [warm_passes[p]["h2d_bytes"],
                          warm_passes[p]["d2h_bytes"]]}
        for name, p in phase7.items()}
    sample3 = sorted(set(ids[::max(1, N_DOCS // 32)])
                     | set(grown[::max(1, len(grown) // 16)]))
    bad3, oracle3_s = oracle_mismatches(service, s3["grown"]["res"], sample3)
    agree = {"exact": s3["exact"]["res"] == s3["cold"]["res"],
             "cold_off": s3["cold"]["res"] == s3["off_cold"]["res"],
             "grown_off": s3["grown"]["res"] == s3["off_grown"]["res"]}
    emit({"phase": "service_s3", "docs": N_DOCS, "base_ops": WARM_BASE_OPS,
          "grown_docs": len(grown), "corpus_build_s": build_s,
          "passes": {k: {x: v for x, v in r.items() if x != "res"}
                     for k, r in s3.items()},
          "bytes_vs_phase7": bytes_vs_phase7, "agree": agree,
          "tiers": {"pack_cache": svc._pack_cache.stats(),
                    "delta_cache": svc.delta_cache.stats(),
                    "device_cache": svc.device_cache.stats()},
          "oracle_sample": len(sample3), "oracle_s": oracle3_s,
          "oracle_mismatches": bad3[:8]})
    check(all(agree.values()) and not bad3, f"S3 {agree} {bad3[:8]}")
    check(s3["exact"]["h2d_bytes"] == 0, "S3 exact pass moved bytes up")
    check(launched("service_s3_grown", "splice_rows") >= 1,
          f"S3 grown pass launched no splice: "
          f"{launches['service_s3_grown']}")
    del svc, off, service, s3
    torch.cuda.empty_cache()

    # -- S4: the tree corpus -------------------------------------------------
    t = time.perf_counter()
    service = LocalOrderingService()
    ids = sw.build_tree_catchup_corpus(service, SVC_TREE_DOCS, TREE_EDITS)
    build_s = time.perf_counter() - t
    svc = CatchupService(service, device=dev)
    res4, wall4, stats4, stage4, pstats4 = call("service_s4_cold", svc, ids,
                                                upload=False)
    hits0 = svc.cache.stats()["hits"]
    res4w, wall4w, stats4w, stage4w, _ = call("service_s4_warm", svc, ids,
                                              upload=False)
    hit_rate = (svc.cache.stats()["hits"] - hits0) / len(ids)
    sample4 = ids[::max(1, len(ids) // SVC_TREE_SAMPLE)]
    bad4, oracle4_s = oracle_mismatches(service, res4, sample4)
    tree_ops = SVC_TREE_DOCS * TREE_EDITS
    emit({"phase": "service_s4", "docs": SVC_TREE_DOCS, "edits": TREE_EDITS,
          "corpus_build_s": build_s, "cold_wall_s": wall4,
          "cold_ops_per_s": tree_ops / wall4, "warm_wall_s": wall4w,
          "warm_ops_per_s": tree_ops / wall4w, "hit_rate": hit_rate,
          "stats": stats4, "pipeline_stats": pstats4, "stage": stage4,
          "warm_stats": stats4w, "warm_stage": stage4w,
          "launches": launches["service_s4_cold"],
          "warm_launches": launches["service_s4_warm"],
          "oracle_sample": len(sample4), "oracle_s": oracle4_s,
          "oracle_mismatches": bad4[:8]})
    check(res4w == res4 and hit_rate == 1.0 and not any(stage4w.values()),
          f"S4 warm: hit rate {hit_rate}, stage {stage4w}")
    check(not any(launches["service_s4_warm"].values()), "S4 warm launched")
    check(launched("service_s4_cold", "tree_fold_digest") >= 1,
          f"S4 launched no tree fold: {launches['service_s4_cold']}")
    check(stats4["cpuDocs"] == 0 and not bad4, f"S4 {stats4} {bad4[:8]}")
    del svc, service
    torch.cuda.empty_cache()

    # -- S5: mixed documents -------------------------------------------------
    t = time.perf_counter()
    service = LocalOrderingService()
    rng = random.Random("mixed")
    runtimes = sw.build_mixed_corpus(service, SVC_MIXED_DOCS, rng,
                                     rounds=SVC_MIXED_ROUNDS)
    build_s = time.perf_counter() - t
    svc = CatchupService(service, device=dev)
    cpu = CatchupService(service, device=dev)
    cpu._device_plan = lambda work: None  # the forced container fold
    s5 = {}
    for rnd in ("cold", "warm"):
        if rnd == "warm":
            for rts in runtimes.values():
                sw.drive_mixed_doc(rts, rng, rounds=SVC_MIXED_WARM_ROUNDS)
        want = cpu.catch_up(upload=False)
        got, wall, stats, stage, pstats = call(f"service_s5_{rnd}", svc)
        path = f"service_s5_{rnd}"
        s5[rnd] = {"wall_s": wall, "stats": stats, "pipeline_stats": pstats,
                   "stage": stage, "launches": launches[path],
                   "equals_container_fold": got == want}
        check(got == want, f"S5 {rnd}: summaries differ from the container "
                           f"fold")
        check(stats["deviceDocs"] == SVC_MIXED_DOCS and stats["cpuDocs"] == 0
              and stats["hostChannels"] > 0, f"S5 {rnd} stats {stats}")
        check(launched(path, "map_lww") == 1
              and launched(path, "matrix_fold") == 1
              and launched(path, "mergetree_fold_export_smem") >= 1
              and launched(path, "tree_fold_digest") >= 1,
              f"S5 {rnd} launches {launches[path]}")
    channel_ops = {}
    for doc_id in runtimes:
        for m in service.oplog.get(doc_id, from_seq=0):
            if isinstance(m.contents, dict) \
                    and m.contents.get("type") == "groupedBatch":
                for op in m.contents["ops"]:
                    channel_ops[op["channel"]] = \
                        channel_ops.get(op["channel"], 0) + 1
    emit({"phase": "service_s5", "docs": SVC_MIXED_DOCS,
          "rounds_cold": SVC_MIXED_ROUNDS,
          "rounds_warm": SVC_MIXED_WARM_ROUNDS,
          "channel_ops_per_doc": {k: v / SVC_MIXED_DOCS
                                  for k, v in channel_ops.items()},
          "corpus_build_s": build_s, "rounds": s5})
    del svc, cpu, service, runtimes
    torch.cuda.empty_cache()

    # -- S6: attribution documents ------------------------------------------
    t = time.perf_counter()
    service = LocalOrderingService()
    ids = sw.build_catchup_corpus(service, SVC_ATTR_DOCS, N_OPS,
                                  attribution=True)
    build_s = time.perf_counter() - t
    svc = CatchupService(service, device=dev)
    res6, wall6, stats6, stage6, pstats6 = call("service_s6", svc, ids,
                                                upload=False)
    bad6, oracle6_s = oracle_mismatches(service, res6, ids)
    svc.catch_up(ids)  # tier-1 hits, uploaded: read the trees back
    keyed = sum("attribution" in service.storage.latest(d)[0].get(
        ".datastores").get("ds").get("text").children for d in ids)
    emit({"phase": "service_s6", "docs": SVC_ATTR_DOCS,
          "window": sw.ATTRIBUTION_WINDOW, "corpus_build_s": build_s,
          "wall_s": wall6, "ops_per_s": SVC_ATTR_DOCS * N_OPS / wall6,
          "stats": stats6, "pipeline_stats": pstats6, "stage": stage6,
          "launches": launches["service_s6"], "keyed_docs": keyed,
          "oracle_docs": len(ids), "oracle_s": oracle6_s,
          "oracle_mismatches": bad6[:8]})
    check(stats6["cpuDocs"] == 0 and not bad6 and keyed == SVC_ATTR_DOCS,
          f"S6 {stats6}, {len(bad6)} mismatches, {keyed} keyed")
    check(launched("service_s6", "mergetree_fold_export_smem") >= 1,
          "S6 launched no fold+export")
    return paths, s1


def free_port() -> int:
    import socket

    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def quiesce(factory, doc_id, containers, timeout=120.0):
    """Drain each container until its ref_seq reaches the server's head
    for ``doc_id`` (bounded); returns that head."""
    storage = factory.resolve(doc_id).delta_storage
    deadline = time.perf_counter() + timeout
    while True:
        head = storage.head()
        for c in containers:
            c.drain()
        if all(c.runtime.ref_seq == head for c in containers) \
                and storage.head() == head:
            return head
        if time.perf_counter() > deadline:
            raise AssertionError(
                f"server: {doc_id} clients at "
                f"{[c.runtime.ref_seq for c in containers]}, head {head}")
        time.sleep(0.005)


class LiveWriter:
    """A Loader container as ``drive_mixed_doc`` drives a runtime: edits
    go through its datastores, ``drain`` flushes and applies over TCP."""

    def __init__(self, container) -> None:
        self.container = container

    def get_datastore(self, name):
        return self.container.runtime.get_datastore(name)

    def drain(self):
        return self.container.drain()


def spawn_server(port, log_path, *args):
    """``python -m fluidframework_tpu_torch.service.server`` (the normal
    entry point) with its output in ``log_path``; waits, bounded, for its
    listening line."""
    log = open(log_path, "a")
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.service.server",
         "--port", str(port), *args], cwd=REPO, stdout=log,
        stderr=subprocess.STDOUT)
    log.close()
    deadline = time.perf_counter() + 180
    while time.perf_counter() < deadline:
        with open(log_path) as f:
            if "listening" in f.read():
                return proc
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    stop_process(proc)
    with open(log_path) as f:
        tail = f.read()[-2000:]
    raise AssertionError(f"server: the spawned server never listened: "
                         f"{tail}")


def stop_process(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=20)


def server_phase(dev, drive, launches, s1):
    """Phase 12: the network ordering server on the card.  The port's
    ``OrderingServer(service, device=dev)`` on a thread, reached over TCP
    through the port's ``NetworkDocumentServiceFactory``, its lazy
    ``CatchupService`` (and the streaming fold on top of it) on ``dev``.
    Sub-phases, each RPC a driven path:

    - R1: one ``catchup`` RPC for S1's corpus (10,240 x 96, cold: a new
      server has its own catch-up service and tier 1): wall, ops/s,
      ``deviceDocs`` / ``cpuDocs``, the admission counters, launches, the
      bytes, the time inside the seam's ``catch_up`` and the RPC's cost
      beyond it, and a 256-document sample equal to the CPU container
      fold;
    - R2: the same RPC again: the warm lane, no launch, no bytes;
    - R3: live ``Loader`` sessions (two writers a document, the mixed
      datastore: string, map, matrix, tree, counter) typing over TCP,
      quiesced by head; a ``catchup`` RPC folds them (K1, K5, K7, K4 each
      launched); a fresh ``Loader`` replays nothing and sees the
      writers' summary;
    - R4: the streaming fold at the gates' defaults over S1's corpus:
      ``note_doc`` for every document, a forced ``stream_poll``, then
      rounds of ``SRV_GROW_OPS`` committed ops a document (through the
      documents' endpoints) and a ``stream_poll`` each: wall, the poll's
      counters, launches, bytes; one more round under the profiler for
      the device busy share; a ``catchup`` RPC within the cadence (the
      stream lane: no launch, the published ref_seqs) and one for
      documents grown past it (the fold lane, at the head); every
      published handle read back, a sample equal to the container fold;
    - R5: the normal entry point in a subprocess (``--device`` of this
      run, ``--dir`` under the gitignored build/): a port client creates
      a document, types, sends ``catchup`` (``deviceDocs == 1``); the
      server restarts on the same ``--dir`` and the document's head and
      latest summary survive.

    Returns the driven paths."""
    import random
    import shutil

    import torch

    from fluidframework_tpu_torch.drivers.network_driver import (
        NetworkDocumentServiceFactory)
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.protocol.messages import (MessageType,
                                                            RawOperation)
    from fluidframework_tpu_torch.runtime.container import ContainerRuntime
    from fluidframework_tpu_torch.service.server import OrderingServer
    from fluidframework_tpu_torch.testing import service_workload as sw
    from fluidframework_tpu_torch.utils.telemetry import (
        CollectingLogger, ConfigProvider, MonitoringContext)

    service, ids = s1["service"], s1["ids"]
    paths = []
    n_ops = len(ids) * N_OPS

    def check(ok, what):
        if not ok:
            raise AssertionError(f"server: {what}")

    def launched(path, *rows):
        return sum(launches[path][k] for r in rows for k in ROW_COUNTS[r])

    def no_launch(path):
        check(not any(launches[path].values()),
              f"{path} launched: {launches[path]}")

    def driven(path, fn):
        """A driven path: its result, wall, and what it added to the
        seam's stage dict."""
        stage0 = dict(catchup.pipeline_stage)
        out, wall = drive(path, fn)
        paths.append(path)
        stage = {k: v - stage0.get(k, 0)
                 for k, v in catchup.pipeline_stage.items()}
        return out, wall, stage

    def rpc(path, factory, method, params):
        """One RPC as a driven path."""
        return driven(path, lambda: factory._rpc.request(
            method, params, timeout=SRV_RPC_TIMEOUT))

    def moved(stage):
        return [stage.get("h2d_bytes", 0), stage.get("d2h_bytes", 0)]

    def chained(doc_id, handle, seq, to_seq):
        """Container fold from a checked summary (``handle`` at ``seq``)
        through the log up to ``to_seq``: the oracle once truncation has
        dropped the log's prefix."""
        rt = ContainerRuntime()
        rt.load(service.storage.read(handle))
        for m in service.oplog.get(doc_id, from_seq=seq, to_seq=to_seq):
            rt.process(m)
        return rt.summarize().digest()

    grower_seq = {}

    def grow(doc_id, n):
        """``n`` committed inserts through the document's endpoint (its
        sequencer's commit watcher feeds the streaming fold)."""
        ep = service.endpoint(doc_id)
        if doc_id not in grower_seq:
            ep.connect("grower")
            grower_seq[doc_id] = 0
        for _ in range(n):
            cseq = grower_seq[doc_id] = grower_seq[doc_id] + 1
            ep.submit(RawOperation(
                client_id="grower", client_seq=cseq,
                ref_seq=service.oplog.head(doc_id), type=MessageType.OP,
                contents={"type": "groupedBatch", "ops": [
                    {"ds": "ds", "channel": "text", "clientSeq": cseq,
                     "contents": {"kind": "insert", "pos": 0,
                                  "text": "g"}}]}))

    picked = {0, len(ids) // 2, len(ids) - 1}
    for i in range(0, len(ids), max(1, len(ids) // ORACLE_SAMPLE)):
        if len(picked) == ORACLE_SAMPLE:
            break
        picked.add(i)
    sample = [ids[i] for i in sorted(picked)]
    t = time.perf_counter()
    want1 = {d: sw.catchup_oracle_digest(service, d) for d in sample}
    oracle1_s = time.perf_counter() - t

    log = CollectingLogger()
    server = OrderingServer(service, device=dev,
                            mc=MonitoringContext(log, ConfigProvider({})))
    thread = server.start_in_thread()
    factories = []

    def connect():
        f = NetworkDocumentServiceFactory(port=server.port,
                                          timeout=SRV_RPC_TIMEOUT)
        factories.append(f)
        return f

    try:
        factory = connect()
        catchup = server._ensure_catchup()

        # -- R1: the fold lane at full width ---------------------------------
        seam = {"s": 0.0}
        real_catch_up = catchup.catch_up

        def timed_catch_up(*a, **k):
            t0 = time.perf_counter()
            try:
                return real_catch_up(*a, **k)
            finally:
                seam["s"] += time.perf_counter() - t0

        catchup.catch_up = timed_catch_up
        try:
            out1, wall1, stage1 = rpc("server_r1_fold", factory, "catchup",
                                      {"docs": ids})
        finally:
            del catchup.catch_up
        r1 = {d: tuple(v) for d, v in out1["docs"].items()}
        bad1 = [d for d in sample if r1[d][0] != want1[d]]
        admission1 = server.admission.snapshot()
        emit({"phase": "server_r1", "docs": len(ids), "ops": n_ops,
              "wall_s": wall1, "ops_per_s": n_ops / wall1,
              "lane": out1["lane"], "deviceDocs": out1["deviceDocs"],
              "cpuDocs": out1["cpuDocs"],
              "hostChannels": out1["hostChannels"],
              "fallbackChannels": out1["fallbackChannels"],
              "seam_catch_up_s": seam["s"],
              "beyond_seam_s": wall1 - seam["s"],
              "in_proc_s1_wall_s": s1["wall_s"],
              "over_in_proc_s1_s": wall1 - s1["wall_s"],
              "admission": admission1,
              "admission_control": server.admission_control.snapshot(),
              "h2d_d2h_bytes": moved(stage1), "stage": stage1,
              "launches": launches["server_r1_fold"],
              "oracle_sample": len(sample), "oracle_s": oracle1_s,
              "oracle_mismatches": bad1[:8]})
        check(out1["lane"] == "fold" and len(r1) == len(ids)
              and out1["skipped"] == [], f"R1 answer {out1['lane']}")
        check(out1["deviceDocs"] == len(ids) and out1["cpuDocs"] == 0,
              f"R1 deviceDocs {out1['deviceDocs']} cpuDocs "
              f"{out1['cpuDocs']}")
        check(not bad1, f"R1 oracle {bad1[:8]}")
        check(all(r1[d][1] == service.oplog.head(d) for d in sample),
              "R1 answered below the head")
        check((admission1["catchup.requests"], admission1["catchup.admitted"],
               admission1["catchup.shed"]) == (1, 1, 0),
              f"R1 admission {admission1}")
        check(launched("server_r1_fold", "mergetree_fold_export_smem") >= 1,
              f"R1 launched no fold+export: {launches['server_r1_fold']}")

        # -- R2: the warm lane -----------------------------------------------
        out2, wall2, stage2 = rpc("server_r2_warm", factory, "catchup",
                                  {"docs": ids})
        emit({"phase": "server_r2", "wall_s": wall2, "lane": out2["lane"],
              "h2d_d2h_bytes": moved(stage2),
              "launches": launches["server_r2_warm"],
              "admission": server.admission.snapshot()})
        check(out2["lane"] == "warm" and out2["docs"] == out1["docs"],
              f"R2 lane {out2['lane']}")
        check(moved(stage2) == [0, 0], f"R2 moved {moved(stage2)}")
        no_launch("server_r2_warm")

        # -- R3: live clients over TCP ---------------------------------------
        def build(rt):
            ds = rt.create_datastore("ds")
            for type_name, channel_id in sw.MIXED_CHANNELS:
                ds.create_channel(type_name, channel_id)

        live = [f"live{i}" for i in range(SRV_LIVE_DOCS)]
        rng = random.Random("server-live")
        writers = {}
        t = time.perf_counter()
        for doc_id in live:
            writers[doc_id] = [Loader(connect()).create(doc_id, "alice",
                                                        build)]
            writers[doc_id].append(Loader(connect()).resolve(doc_id, "bob"))
        for doc_id, pair in writers.items():
            sw.drive_mixed_doc([LiveWriter(c) for c in pair], rng,
                               rounds=SRV_LIVE_ROUNDS)
        heads3 = {d: quiesce(factory, d, pair) for d, pair in writers.items()}
        typing_s = time.perf_counter() - t
        want3 = {d: [c.runtime.summarize().digest() for c in pair]
                 for d, pair in writers.items()}
        out3, wall3, stage3 = rpc("server_r3_live", factory, "catchup",
                                  {"docs": live})
        fresh3 = {}
        for doc_id in live:
            c = Loader(connect()).resolve(doc_id)
            fresh3[doc_id] = (c.catchup_ops, c.runtime.summarize().digest())
            c.close()
        for pair in writers.values():
            for c in pair:
                c.close()
        emit({"phase": "server_r3", "docs": len(live),
              "rounds": SRV_LIVE_ROUNDS, "heads": heads3,
              "typing_s": typing_s, "wall_s": wall3, "lane": out3["lane"],
              "deviceDocs": out3["deviceDocs"], "cpuDocs": out3["cpuDocs"],
              "hostChannels": out3["hostChannels"],
              "fallbackChannels": out3["fallbackChannels"],
              "h2d_d2h_bytes": moved(stage3),
              "launches": launches["server_r3_live"],
              "fresh_catchup_ops": {d: v[0] for d, v in fresh3.items()}})
        check(out3["lane"] == "fold" and out3["deviceDocs"] == len(live)
              and out3["cpuDocs"] == 0, f"R3 answer {out3['lane']} "
              f"{out3['deviceDocs']} {out3['cpuDocs']}")
        for doc_id in live:
            check(want3[doc_id][0] == want3[doc_id][1],
                  f"R3 {doc_id}: the writers disagree")
            check(out3["docs"][doc_id] == [want3[doc_id][0], heads3[doc_id]],
                  f"R3 {doc_id}: catch-up {out3['docs'][doc_id]}")
            check(fresh3[doc_id] == (0, want3[doc_id][0]),
                  f"R3 {doc_id}: fresh load {fresh3[doc_id]}")
        for row in ("mergetree_fold_export_smem", "tree_fold_digest",
                    "map_lww", "matrix_fold"):
            check(launched("server_r3_live", row) >= 1,
                  f"R3 launched no {row}: {launches['server_r3_live']}")

        # -- R4: the streaming fold at full width ----------------------------
        sf = server.enable_streaming()
        check((sf.cadence_ops, sf.retention_floor) == (8, 64),
              f"stream gates {sf.cadence_ops} {sf.retention_floor}")
        for doc_id in ids:
            sf.note_doc(doc_id)
        rounds = {}

        def stream_round(name, grow_ops, force=False, rpc_poll=True):
            t0 = time.perf_counter()
            for doc_id in ids:
                grow(doc_id, grow_ops)
            grow_s = time.perf_counter() - t0
            before = sf.stats()
            if rpc_poll:
                out, wall, stage = rpc(f"server_r4_{name}", factory,
                                       "stream_poll", {"force": force})
            else:
                out, wall, stage = driven(f"server_r4_{name}", lambda: {
                    "folded": sf.poll(force=force)})
            after = sf.stats()
            rec = {"grow_ops": grow_ops, "grow_s": grow_s, "wall_s": wall,
                   "docs_per_s": len(out["folded"]) / wall,
                   "answered_docs": len(out["folded"]),
                   **{k: after[k] - before[k] for k in (
                       "docs_folded", "ops_folded", "publishes",
                       "truncations", "truncated_msgs",
                       "oplog_bytes_reclaimed")},
                   "h2d_d2h_bytes": moved(stage), "stage": stage,
                   "launches": launches[f"server_r4_{name}"],
                   "device_cache": catchup.device_cache.stats()
                   if catchup.device_cache is not None else None}
            rounds[name] = rec
            check(rec["docs_folded"] == len(ids)
                  and rec["publishes"] == len(ids),
                  f"R4 {name}: folded {rec['docs_folded']}, published "
                  f"{rec['publishes']}")
            return out

        stream_round("forced", 0, force=True)
        for r in range(SRV_STREAM_ROUNDS):
            stream_round(f"round{r + 1}", SRV_GROW_OPS)
            check(launched(f"server_r4_round{r + 1}",
                           "mergetree_fold_export_smem") >= 1,
                  f"R4 round {r + 1} launched no fold+export")
        # one more round under the profiler (the Catchup.ProfileDir
        # gate, read at each fold): the device busy share.  Its poll runs
        # here, on the thread that started the profiler in the service
        # phase (the RPC would poll on the server's event-loop thread),
        # with the server idle.
        shutil.rmtree(SRV_TRACE_DIR, ignore_errors=True)
        os.environ["FLUID_TPU_CATCHUP_PROFILEDIR"] = SRV_TRACE_DIR
        try:
            stream_round("profiled", SRV_GROW_OPS, rpc_poll=False)
        finally:
            del os.environ["FLUID_TPU_CATCHUP_PROFILEDIR"]
        fold_s = [e["durationMs"] for e in log.events
                  if e["eventName"] == "catchup:bulkCatchup_end"][-1] / 1e3
        trace = trace_device_seconds(SRV_TRACE_DIR)
        busy = {"traced_wall_s": rounds["profiled"]["wall_s"],
                "traced_fold_s": fold_s,
                "device_busy_share": trace["seconds"]["kernel"] / fold_s,
                "device_busy_share_with_copies":
                    sum(trace["seconds"].values()) / fold_s, **trace}
        check(trace["seconds"]["kernel"] > 0,
              "the stream round's trace holds no CUDA kernel time")

        # a catch-up within the cadence: the stream lane
        epoch = service.storage.epoch
        for doc_id in ids:
            grow(doc_id, SRV_LANE_OPS)
        published = {d: sf.head_index.get(d, epoch) for d in ids}
        out5, wall5, stage5 = rpc("server_r4_stream_lane", factory,
                                  "catchup", {"docs": ids})
        lane_ok = sum(tuple(out5["docs"][d]) == published[d] for d in ids)
        # documents grown past the cadence: the fold lane, at the head
        past = ids[::max(1, len(ids) // SRV_PAST_DOCS)][:SRV_PAST_DOCS]
        for doc_id in past:
            grow(doc_id, SRV_GROW_OPS)
        out6, wall6, stage6 = rpc("server_r4_past_cadence", factory,
                                  "catchup", {"docs": past})
        unreadable = [d for d in ids
                      if service.storage.read(published[d][0]) is None]
        t = time.perf_counter()
        bad4 = [d for d in sample if chained(
            d, *r1[d], published[d][1]) != published[d][0]]
        bad4 += [d for d in past if chained(
            d, *r1[d], service.oplog.head(d)) != out6["docs"][d][0]]
        oracle4_s = time.perf_counter() - t
        emit({"phase": "server_r4", "docs": len(ids),
              "cadence": sf.cadence_ops, "retention": sf.retention_floor,
              "rounds": rounds, "busy": busy,
              "stream_lane": {"wall_s": wall5, "lane": out5["lane"],
                              "stream_docs": len(out5["stream"]),
                              "at_published": lane_ok,
                              "h2d_d2h_bytes": moved(stage5),
                              "launches":
                                  launches["server_r4_stream_lane"]},
              "past_cadence": {"docs": len(past), "wall_s": wall6,
                               "lane": out6["lane"],
                               "deviceDocs": out6["deviceDocs"],
                               "h2d_d2h_bytes": moved(stage6),
                               "launches":
                                   launches["server_r4_past_cadence"]},
              "stats": sf.stats(), "admission": server.admission.snapshot(),
              "floor_sample": {d: service.oplog.floor(d) for d in ids[:4]},
              "unreadable": len(unreadable), "oracle_docs":
                  len(sample) + len(past), "oracle_s": oracle4_s,
              "oracle_mismatches": bad4[:8]})
        check(out5["lane"] == "stream" and len(out5["stream"]) == len(ids)
              and lane_ok == len(ids),
              f"R4 stream lane {out5['lane']}: {len(out5['stream'])} "
              f"stream docs, {lane_ok} at the published ref_seq")
        no_launch("server_r4_stream_lane")
        check(out6["lane"] == "fold" and all(
            out6["docs"][d][1] == service.oplog.head(d) for d in past),
            f"R4 past the cadence: lane {out6['lane']}")
        check(launched("server_r4_past_cadence",
                       "mergetree_fold_export_smem") >= 1,
              "R4 past the cadence launched no fold+export")
        check(not unreadable and not bad4,
              f"R4 unreadable {unreadable[:8]}, oracle {bad4[:8]}")
    finally:
        for f in factories:
            f.close()
        server.loop.call_soon_threadsafe(server._server.close)
        thread.join(timeout=60)
    del server, catchup
    torch.cuda.empty_cache()

    # -- R5: the normal entry point ------------------------------------------
    shutil.rmtree(SRV_R5_DIR, ignore_errors=True)
    os.makedirs(SRV_R5_DIR)
    store = os.path.join(SRV_R5_DIR, "store")
    port = free_port()
    args = ("--device", str(dev), "--dir", store)
    t = time.perf_counter()
    proc = spawn_server(port, os.path.join(SRV_R5_DIR, "start.log"), *args)
    start_s = time.perf_counter() - t
    factory = NetworkDocumentServiceFactory(port=port,
                                            timeout=SRV_RPC_TIMEOUT)
    try:
        c = Loader(factory).create(
            "r5", "alice", lambda rt: rt.create_datastore("ds")
            .create_channel("sequence-tpu", "text"))
        text = c.runtime.get_datastore("ds").get_channel("text")
        for i in range(SRV_R5_OPS):
            text.insert_text(len(text.text), "ab"[i % 2])
            c.drain()
        head5 = quiesce(factory, "r5", [c])
        t = time.perf_counter()
        out7 = factory._rpc.request("catchup", {"docs": ["r5"]},
                                    timeout=SRV_RPC_TIMEOUT)
        rpc7_s = time.perf_counter() - t
        typed = text.text
        c.close()  # its LEAVE lands past the folded head
        head5_closed = factory._rpc.request("head", {"doc": "r5"})
    finally:
        factory.close()
        stop_process(proc)
    t = time.perf_counter()
    proc = spawn_server(port, os.path.join(SRV_R5_DIR, "restart.log"),
                        *args)
    restart_s = time.perf_counter() - t
    factory = NetworkDocumentServiceFactory(port=port,
                                            timeout=SRV_RPC_TIMEOUT)
    try:
        head_after = factory._rpc.request("head", {"doc": "r5"})
        latest = factory._rpc.request("latest_summary", {"doc": "r5"})
        fresh = Loader(factory).resolve("r5")
        fresh_text = fresh.runtime.get_datastore("ds").get_channel(
            "text").text
        fresh.close()
    finally:
        factory.close()
        stop_process(proc)
    emit({"phase": "server_r5", "args": list(args), "ops": SRV_R5_OPS,
          "start_s": start_s, "restart_s": restart_s, "catchup_s": rpc7_s,
          "lane": out7["lane"], "deviceDocs": out7["deviceDocs"],
          "cpuDocs": out7["cpuDocs"], "head": head5,
          "head_after_close": head5_closed, "head_after_restart": head_after,
          "summary_survived": [latest["handle"], latest["ref_seq"]]
          == out7["docs"]["r5"],
          "launches": "not counted: the kernels ran in the spawned "
                      "server's process"})
    check(out7["deviceDocs"] == 1 and out7["cpuDocs"] == 0
          and out7["docs"]["r5"][1] == head5,
          f"R5 catch-up {out7['deviceDocs']} {out7['docs']}")
    check(head_after == head5_closed, f"R5 head {head_after} after the "
          f"restart, {head5_closed} before")
    check([latest["handle"], latest["ref_seq"]] == out7["docs"]["r5"],
          f"R5 latest summary {latest.get('handle')} "
          f"{latest.get('ref_seq')}")
    check(fresh_text == typed, "R5 text after the restart")
    return paths


def mesh_phase(dev, drive, launches, docs, one_device, oracle, sample,
               warm_passes, s1_digests):
    """Phase 13: the doc-sharded fold (``parallel/shard.py``) on device
    lists that name the one card twice (``x2``) and three times (``x3``,
    which pads every batch to a multiple of 3).  Each batch splits into
    equal contiguous parts, one a list entry; each part folds on its
    device with its family's kernel; the host reassembles the parts.
    Sub-phases, each call a driven path:

    - M1: ``replay_mergetree_sharded`` over the pinned workload (10,240 x
      96): digests equal to the one-device pipeline's of phase 6 and the
      256-document oracle sample; K1 (fold+export) once a part;
    - M2: ``replay_tree_sharded`` over S4's streams (2,048 trees x 48):
      equal to ``pipelined_tree_replay`` (summaries and per-reason
      fallback stats), an oracle sample of every shape; K5 once a part;
    - M3 / M4: ``replay_map_sharded`` / ``replay_matrix_sharded`` over the
      phases 9 and 10 main batches: summaries and stats equal to the
      one-device entries'; K7 / K4 once a part;
    - M5: phase 7's warm windows through the doc-sharded tiers on ``x2``
      (cold, exact, grown): every pass equal to the one batch of its
      windows, bytes beside phase 7's, the exact pass moving nothing up,
      the grown pass splicing each part once (K6);
    - M6: ``CatchupService(mesh=doc_mesh(x2), device=...)`` over a fresh
      build of S1's first ``MESH_SEAM_DOCS`` documents, equal to S1's
      results for them.

    Returns the driven paths."""
    import torch

    from fluidframework_tpu_torch.ops.device_cache import DevicePackCache
    from fluidframework_tpu_torch.ops.pipeline import PackCache
    from fluidframework_tpu_torch.ops.tree_kernel import (
        oracle_fallback_summary)
    from fluidframework_tpu_torch.ops.tree_pipeline import (
        pipelined_tree_replay)
    from fluidframework_tpu_torch.parallel import (doc_mesh,
                                                   replay_map_sharded,
                                                   replay_matrix_sharded,
                                                   replay_mergetree_sharded,
                                                   replay_tree_sharded)
    from fluidframework_tpu_torch.service import LocalOrderingService
    from fluidframework_tpu_torch.service.catchup import CatchupService
    from fluidframework_tpu_torch.service.catchup_cache import (
        DeltaExportCache)
    from fluidframework_tpu_torch.testing import service_workload as sw
    from fluidframework_tpu_torch.testing.tree_workload import (
        synth_tree_messages, tree_doc)

    meshes = {k: doc_mesh(v) for k, v in MESH_LISTS.items()}
    paths = []

    def check(ok, what):
        if not ok:
            raise AssertionError(f"mesh: {what}")

    def digests(summaries):
        return [x.digest() for x in summaries]

    def launched(path, *rows):
        return sum(launches[path][k] for r in rows for k in ROW_COUNTS[r])

    def sharded(path, fn):
        out, wall = drive(path, fn)
        paths.append(path)
        return out, wall

    def per_part(path, mesh, *rows):
        n = launched(path, *rows)
        check(n == mesh.size, f"{path}: {rows} launched {n} times, not "
              f"once a part ({mesh.size}): {launches[path]}")
        return n

    # -- M1: the merge-tree family -------------------------------------------
    n_ops = N_DOCS * N_OPS
    for label, mesh in meshes.items():
        path = f"mesh_m1_{label}"
        stats, stage = {}, {}
        got, wall = sharded(path, lambda: replay_mergetree_sharded(
            docs, mesh=mesh, stats=stats, stage=stage))
        got = digests(got)
        bad = [i for i in sample if got[i] != oracle[i]]
        emit({"phase": "mesh_m1", "devices": MESH_LISTS[label],
              "docs": N_DOCS, "ops": n_ops, "wall_s": wall,
              "ops_per_s": n_ops / wall, "launches": launches[path],
              "stats": stats, "stage": stage,
              "h2d_bytes": stage["h2d_bytes"],
              "d2h_bytes": stage["d2h_bytes"],
              "equals_one_device": got == one_device,
              "oracle_sample": len(sample), "oracle_mismatches": bad})
        check(got == one_device and not bad,
              f"M1 {label}: summaries differ from the one-device pipeline "
              f"or the oracle ({bad[:8]})")
        per_part(path, mesh, "mergetree_fold_export_smem")

    # -- M2: the tree family -----------------------------------------------
    tree_docs = [tree_doc(i, m, len(m)) for i, m in enumerate(
        synth_tree_messages(i, MESH_TREE_EDITS)
        for i in range(MESH_TREE_DOCS))]
    want_stats = {}
    want = digests(pipelined_tree_replay(tree_docs, stats=want_stats,
                                         device=dev))
    tree_oracle = {i: oracle_fallback_summary(tree_docs[i]).digest()
                   for i in range(MESH_TREE_SAMPLE)}
    for label, mesh in meshes.items():
        path = f"mesh_m2_{label}"
        stats, stage = {}, {}
        got, wall = sharded(path, lambda: replay_tree_sharded(
            tree_docs, mesh=mesh, stats=stats, stage=stage))
        got = digests(got)
        bad = [i for i, d in tree_oracle.items() if got[i] != d]
        emit({"phase": "mesh_m2", "devices": MESH_LISTS[label],
              "docs": MESH_TREE_DOCS, "edits": MESH_TREE_EDITS,
              "wall_s": wall, "launches": launches[path], "stats": stats,
              "one_device_stats": want_stats, "stage": stage,
              "equals_one_device": got == want,
              "oracle_sample": len(tree_oracle), "oracle_mismatches": bad})
        check(got == want and stats == want_stats and not bad,
              f"M2 {label}: trees differ from the one-device pipeline "
              f"({stats} vs {want_stats}) or the oracle ({bad})")
        per_part(path, mesh, "tree_fold")

    # -- M3 / M4: the map and matrix families ------------------------------
    for tag, name, entry, row in (
            ("m3", "map", replay_map_sharded, "map_lww"),
            ("m4", "matrix", replay_matrix_sharded, "matrix_fold")):
        m_docs, m_want, m_stats = MAIN_BATCHES[name]
        for label, mesh in meshes.items():
            path = f"mesh_{tag}_{label}"
            stats = {}
            got, wall = sharded(path, lambda: entry(m_docs, mesh=mesh,
                                                    stats=stats))
            same = digests(got) == m_want
            emit({"phase": f"mesh_{tag}", "family": name,
                  "devices": MESH_LISTS[label], "docs": len(m_docs),
                  "ops": sum(len(d.ops) for d in m_docs), "wall_s": wall,
                  "launches": launches[path], "stats": stats,
                  "one_device_stats": m_stats, "equals_one_device": same})
            check(same and stats == m_stats,
                  f"{tag.upper()} {label}: {name} summaries or stats "
                  f"differ from the one-device entry")
            per_part(path, mesh, row)

    # -- M5: phase 7's windows through the doc-sharded tiers ----------------
    windows, want_warm = MAIN_BATCHES["warm"]
    mesh = meshes["x2"]
    tiers = {"pack_cache": PackCache(), "delta_cache": DeltaExportCache(),
             "device_cache": DevicePackCache(device=dev)}
    for name, label in (("cold", "base"), ("exact", "base"),
                        ("grown", "grown")):
        path = f"mesh_m5_{name}"
        stats, stage = {}, {}
        got, wall = sharded(path, lambda: replay_mergetree_sharded(
            windows[label], mesh=mesh, stats=stats, stage=stage, **tiers))
        same = digests(got) == want_warm[label]
        emit({"phase": "mesh_m5", "pass": name, "windows": label,
              "devices": MESH_LISTS["x2"], "wall_s": wall,
              "launches": launches[path], "stats": stats,
              "busy_s": {k: v for k, v in stage.items()
                         if not k.endswith("_bytes")},
              "h2d_bytes": stage["h2d_bytes"],
              "d2h_bytes": stage["d2h_bytes"],
              "phase7": {k: warm_passes[name][k]
                         for k in ("wall_s", "h2d_bytes", "d2h_bytes")},
              "tiers": {k: v.stats() for k, v in tiers.items()},
              "equals_batch": same})
        check(same, f"M5 {name}: summaries differ from the one batch")
        per_part(path, mesh, "mergetree_fold_export_smem")
        if name == "exact":
            check(stage["h2d_bytes"] == 0
                  and stage["d2h_bytes"] == 8 * len(windows[label]),
                  f"M5 exact moved {stage['h2d_bytes']} / "
                  f"{stage['d2h_bytes']} B")
        if name == "grown":
            per_part(path, mesh, "splice_rows")

    # -- M6: the seam on the mesh over a fresh build of S1's corpus --------
    service = LocalOrderingService()
    ids = sw.build_catchup_corpus(service, MESH_SEAM_DOCS, N_OPS)
    svc = CatchupService(service, mesh=mesh, device=dev)
    stats = {}
    res, wall = sharded("mesh_m6", lambda: svc.catch_up(
        ids, upload=False, stats=stats))
    same = {d: h for d, (h, _s) in res.items()} == {
        d: s1_digests[d] for d in ids}
    m6_ops = MESH_SEAM_DOCS * N_OPS
    emit({"phase": "mesh_m6", "devices": MESH_LISTS["x2"],
          "docs": MESH_SEAM_DOCS, "ops": m6_ops, "wall_s": wall,
          "ops_per_s": m6_ops / wall, "launches": launches["mesh_m6"],
          "stats": stats, "stage": svc.pipeline_stage, "equals_s1": same})
    check(same and stats["deviceDocs"] == MESH_SEAM_DOCS
          and stats["cpuDocs"] == 0,
          f"M6: results differ from S1's ({stats})")
    per_part("mesh_m6", mesh, "mergetree_fold_export_smem")
    del service, svc, res
    torch.cuda.empty_cache()
    return paths


def frontdoor_phase(dev, drive, launches):
    """Phase 14: the out-of-process tier on the card.  A ``FrontDoor``
    supervising ``FD_SHARDS`` real shard processes (``python -m
    fluidframework_tpu_torch.service.shardhost --device ...``, each with
    its own CUDA context, durable log and catch-up seam), heartbeats on,
    reached over TCP by the port's own client.  Sub-phases:

    - F1: ``FD_DOCS`` documents x 96 ops written through the door
      (batched ingress), then one ``catchup`` RPC a shard: its answer
      folds every one of that shard's documents on the card
      (``deviceDocs``, ``cpuDocs`` 0), every summary equal to this
      process's in-process fold of the logs read back, a sample equal to
      the CPU container fold;
    - F3 (run before F2, while both shards live): ``FD_MIGRATE``
      documents live-migrated from one shard to the other (freeze,
      transfer, import, flip, resume), byte-identical logs and summaries
      after the move;
    - F2: ``FD_GROW_OPS`` more ops a document while one shard process is
      SIGKILLed mid-traffic; failover and adoption, then a ``catchup`` on
      the new owner equal to the in-process fold of the grown logs;
    - F4: the per-shard ``stats`` RPC (pids, documents, the shard's own
      kernel launches) and each shard process's RSS.

    A launch in a shard process is counted there: each step's launches
    are the difference of the shards' ``stats`` before and after it.
    Returns ``{step: launches}``."""
    import shutil
    import threading

    from fluidframework_tpu_torch.drivers.network_driver import (
        RpcError, _RpcClient)
    from fluidframework_tpu_torch.protocol.summary import tree_from_obj
    from fluidframework_tpu_torch.protocol.wire import (
        decode_sequenced_message)
    from fluidframework_tpu_torch.service import LocalOrderingService
    from fluidframework_tpu_torch.service.catchup import CatchupService
    from fluidframework_tpu_torch.service.frontdoor import FrontDoor
    from fluidframework_tpu_torch.testing import service_workload as sw

    def check(ok, what):
        if not ok:
            raise AssertionError(f"frontdoor: {what}")

    def rss_mb(pid):
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
        return None

    shutil.rmtree(FD_DIR, ignore_errors=True)
    os.makedirs(FD_DIR)
    door = FrontDoor(FD_DIR, n_shards=FD_SHARDS, spawn="proc", device=dev,
                     heartbeat_interval=FD_HEARTBEAT,
                     request_timeout=FD_RPC_TIMEOUT)
    starts = {}
    real_spawn = door._spawn

    def timed_spawn(shard_id):
        t0 = time.perf_counter()
        handle = real_spawn(shard_id)
        starts[shard_id] = time.perf_counter() - t0
        return handle

    door._spawn = timed_spawn
    handles = []
    rpc = None
    shard_launches = {}
    try:
        t = time.perf_counter()
        door.start()
        start_s = time.perf_counter() - t
        handles = [door._shard(sid) for sid in door.router.shard_ids()]
        rpc = _RpcClient("127.0.0.1", door.port, timeout=FD_RPC_TIMEOUT)

        def shard_counts():
            out = rpc.request("stats", {})["shards"]
            return {sid: s.get("launches", {}) for sid, s in out.items()
                    if "launches" in s}

        def step(name, fn):
            """One step: its result, wall, and the kernel launches it
            caused in the shard processes (summed over shards)."""
            before = shard_counts()
            t0 = time.perf_counter()
            out = fn()
            wall = time.perf_counter() - t0
            after = shard_counts()
            total = {}
            for sid, counts in after.items():
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v \
                        - before.get(sid, {}).get(k, 0)
            shard_launches[name] = total
            return out, wall

        def read_back(doc_ids):
            """This process's in-process service over the logs read back
            through the door: the seeded summary at 0 and every
            message."""
            inproc = LocalOrderingService()
            seed = sw._seed_summary("sequence-tpu", "text")
            for d in doc_ids:
                inproc.storage.upload(d, seed, 0)
                for m in rpc.request("deltas", {"doc": d}):
                    inproc.oplog.append(d, decode_sequenced_message(m))
            return inproc

        def summary_digests(answer):
            return {d: tree_from_obj(rpc.request(
                "read_summary", {"handle": h})).digest()
                for d, (h, _seq) in answer.items()}

        def inproc_digests(inproc, doc_ids):
            res = CatchupService(inproc, device=dev, cache=None).catch_up(
                doc_ids, upload=False)
            return {d: res[d][0] for d in doc_ids}

        # -- F1: write, then one catchup RPC a shard -------------------------
        t = time.perf_counter()
        ids = sw.write_catchup_corpus(rpc, FD_DOCS, N_OPS,
                                      batch_docs=FD_BATCH_DOCS,
                                      timeout=FD_RPC_TIMEOUT)
        write_s = time.perf_counter() - t
        owners = {}
        for d in ids:
            owners.setdefault(door._route_probe(d)[0], []).append(d)
        f1, f1_walls, answers = {}, {}, {}
        for sid, mine in sorted(owners.items()):
            out, wall = step(f"frontdoor_f1_{sid}", lambda: rpc.request(
                "catchup", {"docs": mine}, timeout=FD_RPC_TIMEOUT))
            f1[sid] = {k: out[k] for k in ("deviceDocs", "cpuDocs", "lane")}
            f1_walls[sid] = wall
            answers.update(out["docs"])
            check(out["deviceDocs"] == len(mine) and out["cpuDocs"] == 0,
                  f"F1 {sid}: deviceDocs {out['deviceDocs']} / cpuDocs "
                  f"{out['cpuDocs']} for {len(mine)} documents")
            check(dev.type != "cuda" or shard_launches[
                f"frontdoor_f1_{sid}"].get("fold_export_smem", 0) >= 1,
                f"F1 {sid}: the shard launched no K1: "
                f"{shard_launches[f'frontdoor_f1_{sid}']}")
        t = time.perf_counter()
        inproc = read_back(ids)
        got = summary_digests(answers)
        want = inproc_digests(inproc, ids)
        sample = ids[::max(1, FD_DOCS // FD_ORACLE_SAMPLE)]
        bad = [d for d in sample
               if got[d] != sw.catchup_oracle_digest(inproc, d)]
        verify_s = time.perf_counter() - t
        rss = {h.shard_id: rss_mb(h.proc.pid) for h in handles}
        emit({"phase": "frontdoor_f1", "shards": FD_SHARDS,
              "docs": FD_DOCS, "ops": FD_DOCS * N_OPS,
              "start_s": start_s, "shard_start_s": starts,
              "write_s": write_s, "write_ops_per_s":
              FD_DOCS * N_OPS / write_s,
              "catchup_s": f1_walls, "answers": f1,
              "docs_per_shard": {k: len(v) for k, v in owners.items()},
              "launches": {k: v for k, v in shard_launches.items()
                           if k.startswith("frontdoor_f1")},
              "equals_inproc_fold": got == want,
              "oracle_sample": len(sample), "oracle_mismatches": bad,
              "verify_s": verify_s, "rss_mb": rss,
              "heartbeat_failures":
                  door.counters.get("fd.heartbeat_failures")})
        check(got == want and not bad,
              f"F1: summaries differ from the in-process fold "
              f"({sum(got[d] != want[d] for d in ids)}) or the container "
              f"fold ({bad[:8]})")
        del inproc

        # -- F3: live-migrate documents while both shards live --------------
        src, dst = sorted(owners)[:2]
        movers = owners[src][:FD_MIGRATE]
        logs_before = {d: rpc.request("deltas", {"doc": d}) for d in movers}
        moved, f3_s = step("frontdoor_f3", lambda: door._control(
            lambda: [door._migrate_doc(d, dst) for d in movers]))
        routed = {d: door._route_probe(d)[0] for d in movers}
        logs_after = {d: rpc.request("deltas", {"doc": d}) for d in movers}
        out3, f3_catchup_s = step("frontdoor_f3_catchup", lambda: rpc.request(
            "catchup", {"docs": movers}, timeout=FD_RPC_TIMEOUT))
        same3 = {d: out3["docs"][d][0] for d in movers} \
            == {d: answers[d][0] for d in movers}
        emit({"phase": "frontdoor_f3", "docs": movers, "from": src,
              "to": dst, "migrate_s": f3_s, "moved": moved,
              "routed": routed, "logs_identical": logs_after == logs_before,
              "catchup_s": f3_catchup_s,
              "answer": {k: out3[k] for k in ("deviceDocs", "cpuDocs",
                                              "lane")},
              "summaries_identical": same3,
              "launches": shard_launches["frontdoor_f3_catchup"]})
        check(all(moved) and set(routed.values()) == {dst}
              and logs_after == logs_before and same3,
              f"F3: migration not byte-identical ({moved}, {routed})")

        # -- F2: SIGKILL a shard mid-traffic ---------------------------------
        victim_sid = src
        victim = door._shard(victim_sid)
        plan = sw.growth_plan(ids, N_OPS, N_OPS + FD_GROW_OPS)
        head = N_OPS + FD_GROW_OPS + 1  # the JOIN, then every op
        progress, errors = [0], []

        def writer():
            try:
                deadline = time.perf_counter() + FD_RPC_TIMEOUT
                for lo in range(0, len(ids), FD_BATCH_DOCS):
                    part = ids[lo:lo + FD_BATCH_DOCS]
                    while part:
                        check(time.perf_counter() < deadline,
                              f"F2 writer past its deadline at {part[:4]}")
                        try:
                            rpc.request("submit_mixed", {"batches": {
                                d: [sw.raw_string_op(*r) for r in plan[d]]
                                for d in part}}, timeout=FD_RPC_TIMEOUT)
                            heads = rpc.request("heads", {"docs": part},
                                                timeout=FD_RPC_TIMEOUT)
                        except (ConnectionError, OSError, RpcError):
                            heads = {}
                        part = [d for d in part if heads.get(d) != head]
                        if part:
                            time.sleep(0.1)
                    progress[0] = lo + FD_BATCH_DOCS
            except BaseException as exc:  # re-raised on the main thread
                errors.append(exc)

        def grow_and_kill():
            thread = threading.Thread(target=writer, daemon=True)
            thread.start()
            deadline = time.perf_counter() + FD_RPC_TIMEOUT
            while progress[0] < len(ids) // 2 and not errors \
                    and time.perf_counter() < deadline:
                time.sleep(0.005)
            killed_at = progress[0]
            victim.proc.kill()  # SIGKILL: no drain, no seal
            thread.join(timeout=FD_RPC_TIMEOUT)
            check(not thread.is_alive(), "F2 writer never finished")
            if errors:
                raise errors[0]
            return killed_at

        before2 = shard_counts()
        t = time.perf_counter()
        killed_at = grow_and_kill()
        grow_s = time.perf_counter() - t
        deadline = time.perf_counter() + 60
        while victim_sid not in door.router.dead() \
                and time.perf_counter() < deadline:
            time.sleep(0.05)
        detect_s = time.perf_counter() - t - grow_s
        check(victim_sid in door.router.dead(),
              "F2: the kill was never detected")
        heads = rpc.request("heads", {"docs": ids}, timeout=FD_RPC_TIMEOUT)
        contiguous = rpc.request("log_contiguous", {"docs": ids},
                                 timeout=FD_RPC_TIMEOUT)
        check(set(heads.values()) == {head} and all(contiguous.values()),
              f"F2: heads {sorted(set(heads.values()))}, contiguous "
              f"{sum(contiguous.values())} of {len(ids)}")
        out2, f2_s = step("frontdoor_f2", lambda: rpc.request(
            "catchup", {"docs": ids}, timeout=FD_RPC_TIMEOUT))
        t = time.perf_counter()
        inproc = read_back(ids)
        got2 = summary_digests(out2["docs"])
        want2 = inproc_digests(inproc, ids)
        verify2_s = time.perf_counter() - t
        survivors = [h for h in handles if h.shard_id != victim_sid]
        emit({"phase": "frontdoor_f2", "victim": victim_sid,
              "killed_after_docs": killed_at, "grow_ops": FD_GROW_OPS,
              "grow_s": grow_s, "detect_s": detect_s, "catchup_s": f2_s,
              "answer": {k: out2[k] for k in ("deviceDocs", "cpuDocs",
                                              "lane", "lanes")},
              "fences": door.stats()["fences"],
              "failovers": door.counters.get("fd.failovers"),
              "adoptions": door.counters.get("fd.adoptions"),
              "heartbeat_failures":
                  door.counters.get("fd.heartbeat_failures"),
              "launches": shard_launches["frontdoor_f2"],
              "before_f2_launches": before2,
              "equals_inproc_fold": got2 == want2, "verify_s": verify2_s,
              "rss_mb": {h.shard_id: rss_mb(h.proc.pid)
                         for h in survivors}})
        check(out2["deviceDocs"] == FD_DOCS and out2["cpuDocs"] == 0,
              f"F2: deviceDocs {out2['deviceDocs']} / cpuDocs "
              f"{out2['cpuDocs']}")
        check(got2 == want2, "F2: summaries differ from the in-process "
              "fold of the grown logs")
        check(dev.type != "cuda" or shard_launches["frontdoor_f2"].get(
            "fold_export_smem", 0) >= 1,
            f"F2: the new owner launched no K1: "
            f"{shard_launches['frontdoor_f2']}")
        del inproc

        # -- F4: the per-shard stats RPC -------------------------------------
        stats4, f4_s = step("frontdoor_f4",
                            lambda: rpc.request("stats", {}))
        shards = {sid: {k: s.get(k) for k in ("pid", "docs", "ops",
                                              "launches")}
                  for sid, s in stats4["shards"].items()}
        emit({"phase": "frontdoor_f4", "stats_s": f4_s, "shards": shards,
              "alive": stats4.get("alive"), "fences": stats4.get("fences"),
              "epoch": stats4.get("epoch"),
              "rss_mb": {h.shard_id: rss_mb(h.proc.pid)
                         for h in survivors}})
        pids = {s["pid"] for s in shards.values() if s.get("pid")}
        check(len(pids) == len(survivors) and os.getpid() not in pids,
              f"F4: stats not from the shard processes: {pids}")
    except BaseException:
        # What the shards said last, and what the door saw, on stderr.
        print(json.dumps({
            "frontdoor_failure": {
                "dead": sorted(door.router.dead()),
                "counters": door.counters.snapshot(),
                "shard_log_tails": {h.shard_id: h.log_tail[-20:]
                                    for h in handles},
                "shard_exit_codes": {h.shard_id: h.proc.poll()
                                     for h in handles}}}),
              file=sys.stderr, flush=True)
        raise
    finally:
        if rpc is not None:
            rpc.close()
        door.close()
        for h in handles:
            if h.proc.poll() is None:
                h.proc.kill()
                h.proc.wait(timeout=20)
    return shard_launches


def scenarios_phase(dev, drive, launches):
    """Phase 15: the port's scenario engine (``testing.scenarios``) with
    every fold on the card, each run a driven path:

    - W1: the catch-up storm (10,000 clients, 128 documents, 4 orderer
      shards) and its never-shed oracle twin through
      ``run_swarm(spec, device=...)``: the storm's real
      ``OrderingServer`` folds each elected catch-up on the card (K1; K7
      for the map channel).  Gated on the storm verdict of the port's
      load-generator CLI (``tools.loadgen.verdict``: its rate floor,
      every request served, the admission balance, every planned fault
      seen, the p99 bound, the twin's ``sampled_digests`` and
      ``per_doc_head``), and a third run of the same spec with
      ``device="cpu"`` (the plain folds) giving the same digests; then
      the same storm as a user runs it,
      ``python -m fluidframework_tpu_torch.tools.loadgen --storm --device
      cuda`` (its ``main``, in this process), whose verdict must pass and
      whose storm counters must equal the in-process run's;
    - W2: tree-collab at the same size with the fold probe: a
      ``CatchupService`` on the card catches the sampled documents up
      cold, then warm from the resident tier (K5 for the trees), equal
      to the ``device="cpu"`` run;
    - W3: the storm out of process (``proc_spawn="proc"``, without the
      in-process fault plan, whose ``catchup`` seams a process tier does
      not schedule): 2 shard processes on the card answer the elected
      clients' ``catchup`` RPCs through the front door; their launches
      are counted in the shard processes (each shard's ``stats`` RPC)
      and the in-process oracle twin's here.

    Returns ``(paths, shard_launches)``: the in-process driven paths and
    {path: launches counted in the shard processes}."""
    import dataclasses
    import shutil

    from fluidframework_tpu_torch.testing.scenarios import (
        build_scenario, oracle_spec, run_swarm)
    from fluidframework_tpu_torch.tools import loadgen

    paths = []

    def check(ok, what):
        if not ok:
            raise AssertionError(f"scenarios: {what}")

    def launched(path, *rows):
        return sum(launches[path][k] for r in rows for k in ROW_COUNTS[r])

    def driven(path, spec):
        """One swarm run on the card as a driven path."""
        result, wall = drive(path, lambda: run_swarm(spec, device=dev))
        paths.append(path)
        return result, wall

    def on_cpu(spec):
        t = time.perf_counter()
        result = run_swarm(spec, device="cpu")
        return result, time.perf_counter() - t

    def record(result, wall):
        return {"wall_s": wall, "sequenced_ops": result.sequenced_ops,
                "ops_per_sec": result.sequenced_ops / wall,
                "joins": result.joins, "sampled_docs":
                    len(result.sampled_digests)}

    storm_keys = ("requests", "served", "warm", "folds", "shed",
                  "degraded", "retries", "fold_errors", "shed_rate",
                  "latency_p50_ticks", "latency_p99_ticks", "elected",
                  "cohort_clipped")
    k1 = ("mergetree_fold_export_smem", "mergetree_fold_export_gmem")
    k5 = ("tree_fold", "tree_fold_digest")

    # -- W1: the catch-up storm and its oracle twin --------------------------
    spec1 = build_scenario("catchup-storm", seed=SCN_SEED,
                           clients=SCN_CLIENTS, docs=SCN_DOCS,
                           shards=SCN_SHARDS)
    r1, wall1 = driven("scenario_w1", spec1)
    o1, wall1o = driven("scenario_w1_oracle", oracle_spec(spec1, r1))
    c1, wall1c = on_cpu(spec1)
    verdict1 = loadgen.verdict(
        r1, wall1, loadgen.GATES_OPS_PER_SEC["catchup-storm"],
        oracle_match=r1.sampled_digests == o1.sampled_digests
        and r1.per_doc_head == o1.per_doc_head,
        storm_report=loadgen.storm_record(spec1, r1))
    emit({"phase": "scenarios_w1", "scenario": "catchup-storm",
          "seed": SCN_SEED, "clients": SCN_CLIENTS, "docs": SCN_DOCS,
          "shards": SCN_SHARDS, **record(r1, wall1),
          "oracle_wall_s": wall1o, "cpu_wall_s": wall1c,
          "storm": {k: r1.storm.get(k) for k in storm_keys},
          "admission": r1.storm.get("admission"),
          "fault_counts": r1.fault_counts, "verdict": verdict1,
          "cpu_digests_equal": c1.sampled_digests == r1.sampled_digests,
          "cpu_identity_equal": c1.identity() == r1.identity(),
          "launches": launches["scenario_w1"],
          "oracle_launches": launches["scenario_w1_oracle"]})
    check(verdict1["passed"], f"W1 storm verdict {verdict1}")
    check(r1.storm["requests"] > 0
          and r1.storm["latency_p99_ticks"] is not None,
          f"W1 stormed no catch-up: {r1.storm}")
    check(c1.sampled_digests == r1.sampled_digests
          and c1.per_doc_head == r1.per_doc_head,
          "W1: the card's run and the plain folds' run differ")
    check(launched("scenario_w1", *k1) >= 1,
          f"W1 launched no K1: {launches['scenario_w1']}")

    # -- W1 through the port's CLI, as a user runs it --------------------------
    os.makedirs(SCN_DIR, exist_ok=True)
    cli_out = os.path.join(SCN_DIR, "w1_cli.json")
    rc, cli_wall = drive("scenario_w1_cli", lambda: loadgen.main([
        "--scenario", "catchup-storm", "--storm", "--seed", str(SCN_SEED),
        "--clients", str(SCN_CLIENTS), "--docs", str(SCN_DOCS),
        "--shards", str(SCN_SHARDS), "--device", str(dev),
        "--out", cli_out]))
    paths.append("scenario_w1_cli")
    with open(cli_out) as f:
        cli = json.load(f)
    cli_run = cli["scenarios"]["catchup-storm"]
    counter_keys = ("requests", "served", "warm", "folds", "shed",
                    "degraded", "retries", "fold_errors",
                    "latency_p99_ticks")
    cli_counters = {k: cli_run["storm"][k] for k in counter_keys}
    run_counters = {k: r1.storm.get(k) for k in counter_keys}
    emit({"phase": "scenarios_w1_cli", "rc": rc, "wall_s": cli_wall,
          "run_wall_s": cli_run["wall_sec"],
          "ops_per_sec": cli_run["ops_per_sec"],
          "gate_ops_per_sec": cli_run["gate_ops_per_sec"],
          "platform": cli["platform"], "passed": cli_run["passed"],
          "oracle_match": cli_run["oracle_match"],
          "storm": cli_counters, "in_process": run_counters,
          "sequenced_ops": [cli_run["sequenced_ops"], r1.sequenced_ops],
          "launches": launches["scenario_w1_cli"]})
    check(rc == 0 and cli_run["passed"] and cli_run["oracle_match"],
          f"W1 through the CLI: rc {rc}, passed {cli_run['passed']}")
    check(cli_counters == run_counters
          and cli_run["sequenced_ops"] == r1.sequenced_ops,
          f"W1 through the CLI: {cli_counters} != {run_counters}")
    check(launched("scenario_w1_cli", *k1) >= 1,
          f"W1 through the CLI launched no K1: "
          f"{launches['scenario_w1_cli']}")
    del r1, o1, c1

    # -- W2: tree-collab with the fold probe ---------------------------------
    spec2 = dataclasses.replace(build_scenario(
        "tree-collab", seed=SCN_SEED, clients=SCN_CLIENTS, docs=SCN_DOCS,
        shards=SCN_SHARDS), fold_probe=True)
    r2, wall2 = driven("scenario_w2", spec2)
    c2, wall2c = on_cpu(spec2)
    ft = r2.fold_tier
    emit({"phase": "scenarios_w2", "scenario": "tree-collab",
          "seed": SCN_SEED, "clients": SCN_CLIENTS, "docs": SCN_DOCS,
          "shards": SCN_SHARDS, **record(r2, wall2), "cpu_wall_s": wall2c,
          "fold_tier": ft, "cpu_fold_tier": c2.fold_tier,
          "cpu_digests_equal": c2.sampled_digests == r2.sampled_digests,
          "cpu_identity_equal": c2.identity() == r2.identity(),
          "launches": launches["scenario_w2"]})
    check(c2.sampled_digests == r2.sampled_digests,
          "W2: the card's run and the plain folds' run differ")
    check(ft["device_cache"]["served"] >= 1
          and ft["tree_device_cache"]["served"] >= 1,
          f"W2: the warm pass did not serve resident: "
          f"{ft['device_cache']} {ft['tree_device_cache']}")
    check(launched("scenario_w2", *k5) >= 1,
          f"W2 launched no K5: {launches['scenario_w2']}")
    del r2, c2

    # -- W3: the storm against shard processes on the card -------------------
    shutil.rmtree(SCN_DIR, ignore_errors=True)
    spec3 = dataclasses.replace(build_scenario(
        "catchup-storm", seed=W3_SEED, clients=W3_CLIENTS, docs=W3_DOCS,
        shards=W3_SHARDS), out_of_proc=True, proc_spawn="proc",
        plan=None, dir=os.path.join(SCN_DIR, "w3"))
    r3, wall3 = driven("scenario_w3", spec3)
    o3, wall3o = driven("scenario_w3_oracle", oracle_spec(spec3, r3))
    shards = r3.shard_stats["cluster"]["shards"]
    shard_counts = {}
    for s in shards.values():
        for k, v in (s.get("launches") or {}).items():
            shard_counts[k] = shard_counts.get(k, 0) + v
    same3 = r3.sampled_digests == o3.sampled_digests \
        and r3.per_doc_head == o3.per_doc_head
    emit({"phase": "scenarios_w3", "scenario": "catchup-storm",
          "proc_spawn": "proc", "seed": W3_SEED, "clients": W3_CLIENTS,
          "docs": W3_DOCS, "shards": W3_SHARDS, **record(r3, wall3),
          "oracle_wall_s": wall3o,
          "storm": {k: r3.storm.get(k) for k in storm_keys + ("wire_clock",)},
          "remote": r3.storm.get("remote"), "oracle_match": same3,
          "shard_pids": {sid: s.get("pid") for sid, s in shards.items()},
          "shard_launches": shard_counts,
          "launches": launches["scenario_w3"],
          "oracle_launches": launches["scenario_w3_oracle"]})
    check(same3, "W3: the process tier's state differs from its twin's")
    check(r3.storm["served"] == r3.storm["requests"] > 0,
          f"W3: served {r3.storm['served']} of {r3.storm['requests']}")
    check(dev.type != "cuda" or sum(shard_counts.get(k, 0) for r in k1
                                    for k in ROW_COUNTS[r]) >= 1,
          f"W3: the shards launched no K1: {shard_counts}")
    shutil.rmtree(SCN_DIR, ignore_errors=True)
    return paths, {"scenario_w3_shards": shard_counts}


def soak_phase(dev, drive, launches):
    """Phase 16: the wire soak on the card.  An in-process
    ``OrderingServer(device=...)`` on a daemon thread; ``SOAK_PROCS``
    subprocesses (``python -m fluidframework_tpu_torch.testing.load
    --wire-worker``) seed ``SOAK_DOCS`` documents of five channel mixes
    (string, map, matrix, tree, string + map) over TCP, each document's
    expected digest from a read-only load at its head; a
    ``CatchupService(device="cpu")`` folds every document with the plain
    folds and uploads nothing; then one ``catchup`` RPC over every
    document (a driven path: K1, K5, K7 and K4 each launched, every
    document on the device route) whose every summary equals the plain
    fold's, and sampled fresh loads with nothing to replay, byte-identical
    to the seeders'.  Returns the driven paths."""
    import torch

    from fluidframework_tpu_torch.drivers.network_driver import (
        NetworkDocumentServiceFactory)
    from fluidframework_tpu_torch.loader import Loader
    from fluidframework_tpu_torch.service import LocalOrderingService
    from fluidframework_tpu_torch.service.catchup import CatchupService
    from fluidframework_tpu_torch.service.server import OrderingServer
    from fluidframework_tpu_torch.testing.load import (
        SOAK_EDITS, SOAK_PROCS, seed_wire_soak)

    def check(ok, what):
        if not ok:
            raise AssertionError(f"soak: {what}")

    def launched(*rows):
        return sum(launches["soak"][k] for r in rows for k in ROW_COUNTS[r])

    service = LocalOrderingService()
    server = OrderingServer(service, device=dev)
    thread = server.start_in_thread()
    check(server.port, "the server never bound its port")
    factory = None
    try:
        t = time.perf_counter()
        expected = seed_wire_soak("127.0.0.1", server.port, SOAK_DOCS,
                                  timeout=SOAK_TIMEOUT)
        seed_s = time.perf_counter() - t
        check(len(expected) == SOAK_DOCS,
              f"{len(expected)} documents seeded of {SOAK_DOCS}")
        t = time.perf_counter()
        plain = CatchupService(service, mesh=None, cache=None,
                               device="cpu").catch_up(upload=False)
        plain_s = time.perf_counter() - t
        factory = NetworkDocumentServiceFactory(
            host="127.0.0.1", port=server.port, timeout=SOAK_TIMEOUT)
        res, rpc_s = drive("soak", lambda: factory._rpc.request(
            "catchup", {}, timeout=SOAK_TIMEOUT))
        msgs = sum(seq for _h, seq in res["docs"].values())
        sample = sorted({min(i, SOAK_DOCS - 1) for i in (
            0, 1, 2, 3, 4, SOAK_DOCS // 2, SOAK_DOCS - 1)})
        loader = Loader(factory)
        bad = []
        for i in sample:
            doc = f"soak{i:05d}"
            c = loader.resolve(doc)
            if c.catchup_ops != 0 \
                    or c.runtime.summarize().digest() != expected[doc]:
                bad.append([doc, c.catchup_ops])
            c.close()
        differ = sorted(
            d for d, (h, seq) in res["docs"].items()
            if d not in plain or plain[d][1] != seq
            or service.storage.read(h).digest() != plain[d][0])
        counts = {row: launched(*rows) for row, rows in (
            ("K1", ("mergetree_fold_export_smem",
                    "mergetree_fold_export_gmem")),
            ("K5", ("tree_fold", "tree_fold_digest")),
            ("K7", ("map_lww",)), ("K4", ("matrix_fold",)))}
        emit({"phase": "soak", "docs": SOAK_DOCS, "procs": SOAK_PROCS,
              "edits": SOAK_EDITS, "seed_s": seed_s, "rpc_s": rpc_s,
              "plain_fold_s": plain_s, "plain_docs": len(plain),
              "plain_mismatches": len(differ),
              "messages": msgs, "ops_per_s": msgs / rpc_s,
              "lane": res.get("lane"), "deviceDocs": res["deviceDocs"],
              "cpuDocs": res["cpuDocs"], "answered": len(res["docs"]),
              "sample": len(sample), "sample_mismatches": bad,
              "kernels": counts, "launches": launches["soak"]})
        check(len(res["docs"]) == SOAK_DOCS, f"{len(res['docs'])} answered")
        check(res["deviceDocs"] == SOAK_DOCS and res["cpuDocs"] == 0,
              f"deviceDocs {res['deviceDocs']} / cpuDocs {res['cpuDocs']}")
        check(len(plain) == SOAK_DOCS and not differ,
              f"{len(differ)} summaries differ from the plain folds' "
              f"(of {len(plain)}): {differ[:8]}")
        check(all(n >= 1 for n in counts.values()),
              f"a kernel family was not launched: {counts}")
        check(not bad, f"fresh loads differ from the seeders': {bad}")
    finally:
        if factory is not None:
            factory.close()
        server.loop.call_soon_threadsafe(server._server.close)
        thread.join(timeout=60)
    del server
    torch.cuda.empty_cache()
    return ["soak"]


def build_interval_containers(service, n_docs, n_ops, base_at):
    """I4's corpus (neither package has a builder of it): ``n_docs``
    containers, each one datastore with one ``SharedString`` channel
    carrying an interval collection.  Each gets the empty seeded summary
    at seq 0 and config #3's stream (``gen_interval_doc(i, n_ops)``) in the
    runtime's groupedBatch envelope; a ``ContainerRuntime`` folds the first
    ``base_at`` ops and its summary (body, header and ``intervals`` blob)
    is uploaded at that seq, the base a catch-up starts from, with the
    later ops the tail.  Returns the doc ids and how many bases carry an
    ``intervals`` blob."""
    from fluidframework_tpu_torch.runtime.container import ContainerRuntime
    from fluidframework_tpu_torch.testing import config_workloads as cw
    from fluidframework_tpu_torch.testing import service_workload as sw

    seed_tree = sw._seed_summary("sequence-tpu", "text")
    ids, with_blob = [], 0
    for i in range(n_docs):
        doc_id = f"ivc{i}"
        msgs = [sw._grouped(m, "text", m.min_seq)
                for m in cw.gen_interval_doc(i, n_ops).ops]
        service.storage.upload(doc_id, seed_tree, 0)
        runtime = ContainerRuntime()
        runtime.load(seed_tree)
        for m in msgs[:base_at]:
            runtime.process(m)
        base = runtime.summarize()
        service.storage.upload(doc_id, base, msgs[base_at - 1].seq)
        channel = base.children[".datastores"].children["ds"] \
            .children["text"]
        with_blob += "intervals" in channel.children
        for m in msgs:
            service.oplog.append(doc_id, m)
        ids.append(doc_id)
    return ids, with_blob


def interval_fuzz_docs(n_docs, obliterate=False):
    """I3's documents: interval fuzz logs of the port's own harness
    (``StringFuzzSpec(intervals=True)``, 3 clients, 25 rounds, as
    tests/torch_corpora.interval_docs; concurrent, so their chunk keeps
    the obliterate and overlap rows), each cold and as a base summary at
    its middle (body and ``intervals`` blob) plus the tail.  With
    ``obliterate`` the spec also obliterates: the documents whose logs mix
    both kinds (the pre-pack oracle route)."""
    import json as json_

    from fluidframework_tpu_torch.dds.sequence import SharedString
    from fluidframework_tpu_torch.ops import mergetree_kernel as mt
    from fluidframework_tpu_torch.testing import fuzz, mocks

    spec = fuzz.StringFuzzSpec(intervals=True, obliterate=obliterate)
    cold, warm = [], []
    for seed in range(n_docs):
        _r, factory = fuzz.run_fuzz(spec, seed=900 + seed, n_clients=3,
                                    rounds=25)
        ops = mocks.channel_log(factory, "fuzz")
        final_seq = factory.sequencer.seq
        final_msn = factory.sequencer.min_seq
        cold.append(mt.MergeTreeDocInput(
            doc_id=f"ivf{seed}", ops=ops, final_seq=final_seq,
            final_msn=final_msn))
        mid_seq = ops[len(ops) // 2].seq
        partial = SharedString("fuzz")
        for m in ops:
            if m.seq <= mid_seq:
                partial.process(m, local=False)
        summary = partial.summarize()
        intervals = (json_.loads(summary.blob_bytes("intervals"))
                     if "intervals" in summary.children else None)
        warm.append(mt.MergeTreeDocInput(
            doc_id=f"ivw{seed}", ops=[m for m in ops if m.seq > mid_seq],
            base_records=json_.loads(summary.blob_bytes("body")),
            base_seq=partial.tree.current_seq,
            base_msn=partial.tree.min_seq, base_intervals=intervals,
            final_seq=final_seq, final_msn=final_msn))
    return cold, warm


def interval_phase(dev, drive, launches):
    """Phase 17: BASELINE.json config #3, SharedString with interval
    collections, on the card; each run a driven path:

    - I1: ``gen_interval_doc`` at the reference's size (2,048 x 96)
      through ``pipelined_mergetree_replay`` and ``replay_mergetree_batch``:
      every summary equal between the two, every 16th document
      byte-identical to the ``SharedString`` oracle (its ``intervals``
      blob included), no fallback, the bytes equal to the layout's, K1
      once a chunk and once;
    - I2: the stabbing workload as the reference's
      ``run_interval_stabbing`` sets it up (10,240 documents, base windows
      of 84 ops, every 8th grown to 96) through the pipeline with the
      three cache tiers: cold (traced under ``torch.profiler`` for the
      device busy share), exact, grown, tiers off and post-invalidation,
      each pass equal to the pass it is checked against, the bytes equal
      to the layout's (cold, exact, tiers off and post-invalidation:
      ``expected_transfer``; grown: ``expected_grown_transfer``) and
      printed beside the JAX package's CPU counters, every 16th grown
      document byte-identical to the oracle, K1 and K6 counted;
    - I3: interval fuzz logs, cold and as a base with an ``intervals``
      blob plus a tail, through both entries on the card against the
      ``device="cpu"`` fold and the oracle; documents mixing intervals
      with obliterate take the pre-pack oracle route on the card too;
    - I4: 1,024 interval containers behind ``CatchupService``: one
      ``catch_up`` on the card from base summaries carrying ``intervals``
      blobs, every summary equal to a ``device="cpu"`` fold of the same
      service.

    Returns the driven paths."""
    import shutil

    import numpy as np
    import torch

    from fluidframework_tpu_torch.convert import tensors_to
    from fluidframework_tpu_torch.ops import fold_cuda
    from fluidframework_tpu_torch.ops import mergetree_kernel as mt
    from fluidframework_tpu_torch.ops.device_cache import DevicePackCache
    from fluidframework_tpu_torch.ops.pipeline import (
        PackCache, pipelined_mergetree_replay)
    from fluidframework_tpu_torch.service import LocalOrderingService
    from fluidframework_tpu_torch.service.catchup import (
        CatchupService, torch_profiler_trace)
    from fluidframework_tpu_torch.service.catchup_cache import (
        DeltaExportCache)
    from fluidframework_tpu_torch.testing import config_workloads as cw
    from fluidframework_tpu_torch.testing import workload

    paths = []
    # launches are counted on the card only (a rehearsal on the CPU runs
    # the plain versions)
    on_card = dev.type == "cuda"

    def check(ok, what):
        if not ok:
            raise AssertionError(f"interval: {what}")

    def digests(summaries):
        return [s.digest() for s in summaries]

    def k1(path):
        return {k: v for k, v in launches[path].items()
                if k.startswith("fold_export")}

    def oracle_misses(docs, got, every):
        return [docs[i].doc_id for i in range(0, len(docs), every)
                if workload.oracle_replay(docs[i]).summarize().digest()
                != got[i]]

    def pipeline(path, docs, trace_dir=None, **tiers):
        stage, stats, packed = {}, {}, []

        def run():
            return pipelined_mergetree_replay(
                docs, chunk_docs=CHUNK_DOCS, stats=stats, stage=stage,
                packed_out=packed, device=dev, **tiers)

        if trace_dir is None:
            got, wall = drive(path, run)
        else:
            with torch_profiler_trace(trace_dir, dev):
                got, wall = drive(path, run)
        paths.append(path)
        return digests(got), {
            "wall_s": wall, "busy_s": {k: v for k, v in stage.items()
                                       if not k.endswith("_bytes")},
            "h2d_bytes": stage["h2d_bytes"], "d2h_bytes": stage["d2h_bytes"],
            "stats": stats, "chunks": len(packed),
            "launches": launches[path]}, packed

    def k1_parity(packed):
        """The fold+export build against the plain decode, fold, export
        and digest on each chunk's uploaded inputs, digest off and on."""
        err = 0
        for _s, ops, meta, S in packed:
            o = tensors_to(ops, dev)
            base = torch.from_numpy(meta["doc_base"]).to(dev)
            layout = mt._export_flags(meta)
            for digest in (False, True):
                err = max(err, leaves_diff(
                    mt.export_reference(None, o, base, layout, digest, S=S),
                    fold_cuda.fold_export(None, o, base, layout, digest,
                                          S=S)))
        return err

    def batch(path, docs):
        stats = {}
        got, wall = drive(path, lambda: mt.replay_mergetree_batch(
            docs, stats=stats, device=dev))
        paths.append(path)
        return digests(got), {"wall_s": wall, "stats": stats,
                              "launches": launches[path]}

    # -- I1: config #3 at the reference's size -------------------------------
    t = time.perf_counter()
    docs = [cw.gen_interval_doc(i, IV_CFG_OPS) for i in range(IV_CFG_DOCS)]
    gen_s = time.perf_counter() - t
    n_iv = sum(1 for d in docs for m in d.ops
               if m.contents["kind"].startswith("interval"))
    p_dig, p_rec, packed = pipeline("interval_i1_pipeline", docs)
    b_dig, b_rec = batch("interval_i1_batch", docs)
    want = expected_transfer(packed)
    i1_err = k1_parity(packed)
    t = time.perf_counter()
    bad = oracle_misses(docs, p_dig, IV_ORACLE_EVERY)
    oracle_s = time.perf_counter() - t
    ops_n = IV_CFG_DOCS * IV_CFG_OPS
    emit({"phase": "interval_i1", "docs": IV_CFG_DOCS, "ops": ops_n,
          "interval_ops": n_iv, "gen_s": gen_s, "pipeline": p_rec,
          "ops_per_s": ops_n / p_rec["wall_s"], "batch": b_rec,
          "layouts": [mt._export_flags(m) for _s, _o, m, _t in packed],
          "bytes_expected": want, "equals_batch": p_dig == b_dig,
          "k1_max_abs_err": i1_err,
          "oracle_sample": len(range(0, IV_CFG_DOCS, IV_ORACLE_EVERY)),
          "oracle_mismatches": bad, "oracle_s": oracle_s})
    check(p_dig == b_dig, "I1: the pipeline and the one batch differ")
    check(i1_err == 0, f"I1: fold+export != plain ({i1_err})")
    check(not bad, f"I1: summaries differ from the oracle at {bad[:8]}")
    for rec in (p_rec, b_rec):
        check(rec["stats"].get("fallback_docs", 0) == 0
              and rec["stats"]["device_docs"] == IV_CFG_DOCS,
              f"I1 routing {rec['stats']}")
    check((p_rec["h2d_bytes"], p_rec["d2h_bytes"]) == want,
          f"I1 bytes {p_rec['h2d_bytes']} / {p_rec['d2h_bytes']}, "
          f"layout {want}")
    check(not on_card or sum(k1("interval_i1_pipeline").values())
          == len(packed) and sum(k1("interval_i1_batch").values()) == 1,
          f"I1 K1 launches {k1('interval_i1_pipeline')} / "
          f"{k1('interval_i1_batch')}")
    del docs

    # -- I2: the stabbing workload through the three tiers ------------------
    with open(os.path.join(REPO, IV_REFERENCE)) as f:
        ref = json.load(f)["interval_stabbing"]
    t = time.perf_counter()
    grow = IV_OPS // 8
    base = [cw.synth_interval_doc(i, IV_OPS, n_msgs=IV_OPS - grow)
            for i in range(IV_DOCS)]
    grown_idx = set(range(0, IV_DOCS, GROW_EVERY))
    # a document that does not grow keeps its base window
    grown = [cw.synth_interval_doc(i, IV_OPS) if i in grown_idx else base[i]
             for i in range(IV_DOCS)]
    gen_s = time.perf_counter() - t
    n_iv = sum(1 for d in base for m in d.ops
               if m.contents["kind"].startswith("interval"))
    pack, resident, delta = PackCache(), DevicePackCache(device=dev), \
        DeltaExportCache()
    on = {"pack_cache": pack, "device_cache": resident,
          "delta_cache": delta}
    passes, dig = {}, {}
    shutil.rmtree(IV_TRACE_DIR, ignore_errors=True)
    dig["cold"], passes["cold"], cold_packed = pipeline(
        "interval_cold", base, IV_TRACE_DIR, **on)
    dig["exact"], passes["exact"], _ = pipeline("interval_exact", base, **on)
    dig["grown"], passes["grown"], grown_packed = pipeline(
        "interval_grown", grown, **on)
    grown_tiers = {k: v.stats() for k, v in on.items()}
    # the spliced resident op planes against the grown chunks' uploaded
    # arrays (what a plain upload would hold), every plane bit for bit
    k6_err = max(tree_diff(mt.MTOps(*(torch.from_numpy(
        np.ascontiguousarray(x)).to(dev) for x in host_ops)),
        resident._entries[tuple(d.cache_token for d in meta["docs"])].ops)
        for _s, host_ops, meta, _t in grown_packed)
    i2_err = k1_parity(cold_packed[:1])
    dig["off"], passes["off"], off_packed = pipeline("interval_off", grown)
    delta.invalidate_epoch("other-epoch")
    resident.invalidate_epoch("other-epoch")
    dig["inval"], passes["inval"], inval_packed = pipeline(
        "interval_inval", grown, **on)
    chunks = len(cold_packed)
    changed = [sum(1 for i in grown_idx
                   if c * CHUNK_DOCS <= i < (c + 1) * CHUNK_DOCS)
               for c in range(chunks)]
    want = {"cold": expected_transfer(cold_packed, tiers=True),
            "exact": (0, 8 * IV_DOCS),
            "grown": expected_grown_transfer(cold_packed, grown_packed,
                                             changed, dev.type == "cuda"),
            "off": expected_transfer(off_packed),
            "inval": expected_transfer(inval_packed, tiers=True)}
    ref_name = {"cold": "cold", "exact": "warm_exact", "grown": "warm_grown",
                "off": "caches_off", "inval": "post_invalidation"}
    for name, rec in passes.items():
        got = (rec["h2d_bytes"], rec["d2h_bytes"])
        r = ref[ref_name[name]]
        rec.update(bytes_expected=want[name], bytes_equal=got == want[name],
                   reference={"h2d_bytes": r["h2d_bytes"],
                              "d2h_bytes": r["d2h_bytes"],
                              "stats": r["stats"]},
                   equals_reference=got == (r["h2d_bytes"], r["d2h_bytes"])
                   and rec["stats"] == r["stats"],
                   k1=sum(k1(f"interval_{name}").values()),
                   k6={k: launches[f"interval_{name}"][k]
                       for k in ("splice_rows", "widen_resident")})
        emit({"phase": "interval_pass", "pass": name, **rec})
    trace = trace_device_seconds(IV_TRACE_DIR)
    kernel_s = trace["seconds"]["kernel"]
    t = time.perf_counter()
    bad = oracle_misses(grown, dig["grown"], IV_ORACLE_EVERY)
    oracle_s = time.perf_counter() - t
    agree = {"exact=cold": dig["exact"] == dig["cold"],
             "off=grown": dig["off"] == dig["grown"],
             "inval=grown": dig["inval"] == dig["grown"]}
    emit({"phase": "interval_stabbing", "docs": IV_DOCS, "ops": IV_OPS,
          "base_ops": IV_OPS - grow, "grown_docs": len(grown_idx),
          "interval_ops": n_iv, "reference_interval_ops":
              ref["interval_ops"], "gen_s": gen_s, "agree": agree,
          "walls_s": {k: v["wall_s"] for k, v in passes.items()},
          "grown_tiers": grown_tiers, "k1_max_abs_err": i2_err,
          "resident_vs_grown_max_abs_err": k6_err,
          "tiers": {k: v.stats() for k, v in on.items()},
          "reference_tiers": {k: ref[k] for k in (
              "pack_cache", "device_cache", "delta_cache")},
          "oracle_sample": len(range(0, IV_DOCS, IV_ORACLE_EVERY)),
          "oracle_mismatches": bad, "oracle_s": oracle_s,
          "cold_busy": {"device_busy_share": kernel_s
                        / passes["cold"]["wall_s"],
                        "device_busy_share_with_copies":
                            sum(trace["seconds"].values())
                            / passes["cold"]["wall_s"], **trace}})
    check(IV_DOCS != ref["docs"] or n_iv == ref["interval_ops"],
          f"I2 generated {n_iv} interval ops, the reference "
          f"{ref['interval_ops']}")
    check(all(agree.values()), f"I2 passes disagree: {agree}")
    check(i2_err == 0 and k6_err == 0, f"I2: fold+export != plain "
          f"({i2_err}) or the spliced resident planes differ ({k6_err})")
    check(not bad, f"I2 grown summaries differ from the oracle at {bad[:8]}")
    for name, rec in passes.items():
        check(rec["bytes_equal"], f"I2 {name} bytes "
              f"{rec['h2d_bytes']} / {rec['d2h_bytes']}, layout "
              f"{rec['bytes_expected']}")
        check(rec["stats"].get("fallback_docs", 0) == 0,
              f"I2 {name} fell back: {rec['stats']}")
        check(not on_card or rec["k1"] == chunks,
              f"I2 {name}: K1 {rec['k1']} launches "
              f"for {chunks} chunks")
    check(passes["grown"]["stats"].get("delta_docs") == IV_DOCS
          - len(grown_idx) and passes["grown"]["stats"]["device_docs"]
          == len(grown_idx), f"I2 grown routing {passes['grown']['stats']}")
    check(grown_tiers["device_cache"]["spliced"] == chunks
          and (not on_card or passes["grown"]["k6"]["splice_rows"] >= 1),
          f"I2 grown: the resident tier did not splice every chunk "
          f"({grown_tiers['device_cache']}, {passes['grown']['k6']})")
    check(not on_card or kernel_s > 0,
          "the cold pass's trace holds no CUDA kernel time")
    del base, grown, cold_packed, grown_packed, off_packed, inval_packed
    del pack, resident, delta, on
    torch.cuda.empty_cache()

    # -- I3: the hard cases --------------------------------------------------
    cold, warm = interval_fuzz_docs(IV_FUZZ_DOCS)
    mixed, _ = interval_fuzz_docs(IV_FUZZ_DOCS, obliterate=True)
    mixed = [d for d in mixed if mt.known_oracle_fallback(d)]
    check(mixed, "I3: no fuzz log mixes intervals with an obliterate")
    check(sum(d.base_intervals is not None for d in warm) > 0,
          "I3: no base carries an intervals blob")
    hard = {}
    for label, docs in (("cold", cold), ("warm", warm), ("mixed", mixed)):
        want = [mt.oracle_fallback_summary(d).digest() for d in docs]
        cpu_stats = {}
        cpu = digests(mt.replay_mergetree_batch(docs, stats=cpu_stats,
                                                device="cpu"))
        b_dig, b_rec = batch(f"interval_i3_{label}_batch", docs)
        p_dig, p_rec, packed = pipeline(f"interval_i3_{label}_pipeline",
                                        docs)
        hard[label] = {
            "docs": len(docs), "batch": b_rec, "pipeline": p_rec,
            "cpu_stats": cpu_stats,
            "layouts": [mt._export_flags(m) for _s, _o, m, _t in packed],
            "with_base_intervals": sum(d.base_intervals is not None
                                       for d in docs),
            "equal_cpu": b_dig == cpu == p_dig,
            "oracle_mismatches": [docs[i].doc_id for i in range(len(docs))
                                  if b_dig[i] != want[i]]}
        check(hard[label]["equal_cpu"] and not
              hard[label]["oracle_mismatches"],
              f"I3 {label}: card / cpu / oracle differ {hard[label]}")
        # concurrent logs can overflow the device's two remover slots
        # (the post-fold fallback, as on the CPU); a mixed log never packs
        check(b_rec["stats"] == p_rec["stats"] == cpu_stats
              and (label != "mixed"
                   or cpu_stats.get("fallback_docs") == len(docs)),
              f"I3 {label} routing {b_rec['stats']} / {p_rec['stats']} / "
              f"{cpu_stats}")
    emit({"phase": "interval_hard", **hard})

    # -- I4: interval containers behind the seam ------------------------------
    service = LocalOrderingService()
    t = time.perf_counter()
    ids, with_blob = build_interval_containers(
        service, IV_SEAM_DOCS, IV_CFG_OPS, IV_SEAM_BASE)
    build_s = time.perf_counter() - t
    svc = CatchupService(service, device=dev)
    res, wall = drive("interval_seam", lambda: svc.catch_up(
        ids, upload=False))
    paths.append("interval_seam")
    t = time.perf_counter()
    plain_svc = CatchupService(service, mesh=None, cache=None,
                               device="cpu")
    plain = plain_svc.catch_up(ids, upload=False)
    plain_s = time.perf_counter() - t
    differ = sorted(d for d in ids if res.get(d) != plain.get(d))
    emit({"phase": "interval_seam", "docs": IV_SEAM_DOCS,
          "base_at": IV_SEAM_BASE, "bases_with_intervals": with_blob,
          "build_s": build_s, "wall_s": wall, "plain_s": plain_s,
          "deviceDocs": svc.device_docs, "cpuDocs": svc.cpu_docs,
          "plain_deviceDocs": plain_svc.device_docs,
          "mismatches": len(differ), "stage": svc.pipeline_stage,
          "stats": svc.pipeline_stats,
          "launches": launches["interval_seam"]})
    check(with_blob > IV_SEAM_DOCS // 2,
          f"I4: {with_blob} bases carry an intervals blob")
    check(len(res) == IV_SEAM_DOCS and not differ,
          f"I4: {len(differ)} summaries differ from the plain fold's: "
          f"{differ[:8]}")
    check(svc.device_docs == IV_SEAM_DOCS and svc.cpu_docs == 0,
          f"I4 deviceDocs {svc.device_docs} / cpuDocs {svc.cpu_docs}")
    check(not on_card or sum(k1("interval_seam").values()) >= 1,
          f"I4 launched no K1: {launches['interval_seam']}")
    del svc, plain_svc, service
    torch.cuda.empty_cache()
    return paths


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
           for k in ("fold", "fold_export")]
    ptxas = {}
    for source in ("mergetree_fold", "resident", "tree_fold", "map_lww",
                   "matrix_fold"):
        with open(_cuda_build.library_path(source) + ".log") as f:
            ptxas[source] = [ln.strip() for ln in f if "registers" in ln
                             or "spill" in ln or "smem" in ln]
    from fluidframework_tpu_torch.ops import matrix_fold_cuda

    emit({"phase": "build", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "seconds": {k: v[1] for k, v in built.items()},
          "ptxas": ptxas, "occupancy": occ,
          "matrix_fold_occupancy": [matrix_fold_cuda.occupancy(S)
                                    for S in (128, LARGE_S, 2 * LARGE_S)]})

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
    k6_rows, warm_passes = warm_phase(dev, docs, sample, drive, launches)

    # -- 8. SharedTree catch-up at full width ------------------------------
    k5_rows, tree_splice = tree_phase(dev, drive, launches)
    k6_rows[0]["tree_grown"] = tree_splice

    # -- 9. SharedMap catch-up at full width -------------------------------
    k7_row = map_phase(dev, drive, launches, card)

    # -- 10. SharedMatrix catch-up at full width ---------------------------
    k4_rows = matrix_phase(dev, drive, launches, card)

    # -- 11. the catch-up service seam -------------------------------------
    service_paths, s1 = service_phase(dev, drive, launches, warm_passes)

    # -- 12. the network ordering server -----------------------------------
    server_paths = server_phase(dev, drive, launches, s1)
    s1_digests = s1["digests"]
    del s1

    # -- 13. the doc-sharded fold on device lists ---------------------------
    mesh_paths = mesh_phase(dev, drive, launches, docs, digests(p_summaries),
                            oracle, sample, warm_passes, s1_digests)
    del s1_digests
    MAIN_BATCHES.clear()

    # -- 14. the out-of-process tier ---------------------------------------
    fd_launches = frontdoor_phase(dev, drive, launches)

    # -- 15. the scenario engine on the card ---------------------------------
    scenario_paths, scenario_shard_launches = scenarios_phase(
        dev, drive, launches)

    # -- 16. the wire soak --------------------------------------------------
    soak_paths = soak_phase(dev, drive, launches)

    # -- 17. the interval configuration --------------------------------------
    interval_paths = interval_phase(dev, drive, launches)

    # -- 18. times ---------------------------------------------------------
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

    rows = [
        entry("fold_smem", "smem", "state", [D, S, T, K],
              parity["fold_smem"], ms, call_ms, plain_ms, bound),
        entry("fold_gmem", "gmem", "large_state", [wave, lg_S, lg_T, 1],
              parity["fold_gmem"], lg_ms, lg_call_ms, lg_plain_ms, lg_bound),
        entry("fold_export_smem", "smem", "pipeline", [D, S, T, K],
              parity["fold_export_smem"], fx[0], fx[2], fx[3], fx[4]),
        entry("fold_export_gmem", "gmem", "large_pipeline",
              [wave, lg_S, lg_T, 1], parity["fold_export_gmem"], lg_fx[0],
              lg_fx[2], lg_fx[3], lg_fx[4]),
    ] + [dict(r, card=card) for r in k6_rows + k5_rows] + k4_rows \
        + [k7_row]
    for r in rows:
        r["service_launches"] = {
            path: sum(launches[path][k] for k in ROW_COUNTS[r["name"]])
            for path in service_paths}
        r["server_launches"] = {
            path: sum(launches[path][k] for k in ROW_COUNTS[r["name"]])
            for path in server_paths}
        r["mesh_launches"] = {
            path: sum(launches[path][k] for k in ROW_COUNTS[r["name"]])
            for path in mesh_paths}
        r["frontdoor_launches"] = {
            path: sum(counts.get(k, 0) for k in ROW_COUNTS[r["name"]])
            for path, counts in fd_launches.items()}
        r["scenario_launches"] = {
            path: sum(launches[path][k] for k in ROW_COUNTS[r["name"]])
            for path in scenario_paths}
        r["scenario_launches"].update({
            path: sum(counts.get(k, 0) for k in ROW_COUNTS[r["name"]])
            for path, counts in scenario_shard_launches.items()})
        r["soak_launches"] = {
            path: sum(launches[path][k] for k in ROW_COUNTS[r["name"]])
            for path in soak_paths}
        r["interval_launches"] = {
            path: sum(launches[path][k] for k in ROW_COUNTS[r["name"]])
            for path in interval_paths}
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
