// Merge-tree catch-up op-fold for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fluidframework_tpu/ops/pallas_fold.py:_fold_kernel
// (entry replay_vmapped_pallas, step _apply_op_rows): every document's
// sequenced op tail folded into its segment pool, bit for bit the
// semantics of mergetree_kernel._apply_op / _split_at / _visible_len.
//
// Design.  One warp folds one document; a block holds W such warps, W
// derived at launch from the shared memory a document needs (the W of
// 1, 2, 4, 8 that keeps the most documents resident per SM, by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, found once per device, S
// and K and kept for later launches).  The warp keeps its document's
// state (12 int32 slot planes [S] + props [S][K]), the view's visible
// lengths and prefix [S] each, and a tile of kOpTile op rows in
// its own slice of shared memory, so device memory sees the state once in
// and once out and every op row once.  What replaced each limit of the
// earlier block-per-document design:
//   1. No block barriers.  Warps never wait for one another: warp
//      shuffles scan the view (a running carry across 32-slot chunks),
//      __ballot_sync + __ffs finds the "first slot where ...", and
//      __any_sync folds the overflow flag.  A warp past the last document
//      exits at once; no block barrier exists anywhere in the kernel.
//   2. Live slots only.  Every pass runs over [0, n) at the row's n (the
//      view stops early once the rest cannot matter), and a row's move
//      touches only the slots from its first split, insert or stamped
//      index on.  Dead slots [n, S) are never touched: the packer and
//      cold_start fill each plane's dead region with one value, and the
//      plain fold's shifts carry only that fill into dead slots, so the
//      region left in place equals the plain fold's.
//   3. One view per op row.  See "One view per row" below: the view taken
//      before the splits locates both splits, the insert's index and every
//      slot's view after the splits, and one combined move writes each
//      slot once to its final place, with the split halves, the new slot
//      and the range stamps.
//   4. One copy of the state.  The move runs top down in 32-slot chunks:
//      read the chunk, __syncwarp, write at s + delta with delta >= 0, so
//      no unread slot is overwritten.  13 x 192 x 4 = 9,984 B of state at
//      the pinned shape (14,096 B a document with the view and op tile);
//      S reaches 3,072 for K = 1.
//   5. Bulk copies.  Lanes of the warp issue cp.async.bulk copies of the
//      document's contiguous rows (12 planes, props, 9 op fields, pvals)
//      global -> shared, completing on the warp's mbarrier, and
//      shared -> global at the end.  Every row is a multiple of 16 bytes
//      (the wrapper refuses shapes whose rows are not).  One stage: a
//      document's load is not overlapped with another's fold by the warp
//      itself; the other warps resident on the SM fill that time.  Measured
//      at the pinned batch on an H100 (700 W) by tools/torch_fold_variants.py:
//      the copies alone take 0.095 ms of the kernel's 1.11 ms, and reserving
//      a second stage's shared memory halves the documents per SM (16 -> 8)
//      and takes the kernel to 1.84 ms, so a second stage does not pay.
// Tensor cores do not apply: the fold is integer branches, scans and
// moves, with no product in it.
//
// Bound.  Device memory traffic is state in + state out + ops once, about
// 244 MB at the pinned workload (D = 10,240, S = 192, T = 96, K = 1):
// ~73 us at 3.35 TB/s; the integer work those inputs need is ~1.5 G
// operations, ~90 us at the int32 rate.  What holds this design back is
// the chain each warp runs: its document's 96 dependent rows of
// shared-memory loads, shuffles and ballots, hidden only by the other
// documents resident on the SM.  At the pinned shape a document takes
// 14,096 B of shared memory, 4 documents to a block, 16 documents per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, measured by
// chip_smoke.py; 80 registers a thread allow 25).  Measured there on an
// H100 (700 W): 1.11 ms, 12x the bound; of a warp's cycles the view takes
// 37%, the moves 47%, the insert's neighbour search 14%, the bulk copies 3%.
//
// Two placements of the same fold (template parameter kGmem).  A document
// whose working set (doc_words below) fits the 227 KB a block can address
// folds in shared memory as above.  A larger one (S above ~3,830 for K = 1,
// e.g. S = 4,096 for a cold document of more than 2,048 ops) folds in its
// own slice of a device-memory scratch buffer [D, doc_words] that the
// wrapper allocates: the same Doc accessors over generic pointers, with
// plain coalesced copies in place of the bulk copies and mbarrier, and one
// document per block, 8 resident per SM (the occupancy query, carveout
// given to L1).  Measured by chip_smoke.py on an H100 (700 W) at S = 4,096:
// a full wave of 1,056 documents of 2,000 ops in 161 ms, 41x its bound;
// the first 8 alone (one a SM, an L1 each) in 38 ms.  With 8 warps of an
// SM sharing its L1 (2 MB of working state), a document takes 4.2x as long
// as alone, and the 8 together do 1.9x the work of one.
//
// Two entries (template parameter kExport).  The state-out entry
// (mergetree_fold, mergetree_fold_gmem) writes the 12 planes, props, n and
// overflow back.  The fold+export entry (mergetree_fold_export) is the
// reference's replay_export fused into the kernel, replacing its XLA
// prologue and epilogue (mergetree_kernel._cold_start, _widen_ops,
// _widen_state, _export_state, _doc_digests):
//   - prologue: a cold chunk's empty state is built in the working area (no
//     state is read); a warm one is read as int32 or as the int16 upload
//     encoding (tstart rebased on live slots, I16_NOT_REMOVED mapped back).
//     Op rows are read with ordinary coalesced loads (int8 rows at T = 24
//     are 24 bytes, which a bulk copy cannot move) as int32 or as the
//     narrow upload encoding (int8 kind/client, int16 others, insert tstart
//     rebased by doc_base[d]);
//   - epilogue: straight from the working area, the transfer buffer in the
//     chunk's layout (int32, int16, or int8 pairs in int16 lanes with the
//     [D, 4] int32 misc leaf; obliterate, overlap-remover and props rows
//     elided as the host says), and with digest the [D, 2] state digest
//     (uint32 arithmetic; each lane sums its slots, a warp reduction adds
//     them).  At the pinned shape this writes ~15.9 MB in place of the
//     ~102 MB int32 state and torch's re-read to build the export.
//
// One view per row.  Take v (visible length) and cum (its exclusive
// prefix) once, on the row's state before its splits.  A split changes
// no slot's visibility (both halves keep the stamps), so:
//   - split a is at ia, the one live slot with cum < a < cum + v (visible
//     slots' open intervals are disjoint), at offset a - cum[ia];
//   - split b (range rows) is at ib, found the same way.  When ib == ia,
//     b falls in the same segment: it is cut at b too (in the right half
//     when b > a), unless b == a, which is then a boundary of the halves;
//     otherwise it lies at its own index, + 1 when ia < ib;
//   - the insert's tie-break slot (the first live slot with cum >= a after
//     the split) is ja, the first live slot with cum >= a before it, else
//     n: when split a happened, ja == ia + 1 and the right half sits
//     there with cum a.  The new slot lands at final index ja;
//   - each slot s keeps cum[s] and v[s] after the splits; a split slot's
//     pieces span [cum, cut), [cut, ...), [..., cum + v), each visible
//     with its own length.  covered / obl_zero of the range tail are read
//     per piece from those;
//   - piece k of slot s lands at p = s + (cuts in slots before s) + k,
//     plus one when an insert's new slot sits at or below p (p >= ja).
// Slots before the first split, insert or stamped index (min of ia, ib,
// ja; range rows stamp only from ja on) do not change.  A range row with
// no split moves nothing and stamps only the slots whose cum < max(a, b),
// which is where the view stops.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int32_t kNotRemoved = 0x7fffffff;
constexpr int32_t kPropAbsent = -1;
constexpr int32_t kPropNotTouched = -2;
// Sentinels of the narrow encodings (mergetree_kernel.I16_NOT_REMOVED and
// I8_NOT_REMOVED): NOT_REMOVED as it rides an int16 or an int8 lane.
constexpr int32_t kI16NotRemoved = 32767;
constexpr int32_t kI8NotRemoved = 127;

enum Plane {
  TSTART, TLEN, INS_SEQ, INS_CLIENT, REM_SEQ, REM_CLIENT, REM2_SEQ,
  REM2_CLIENT, OB1_SEQ, OB1_CLIENT, OB2_SEQ, OB2_CLIENT, N_FIXED
};
enum OpField {
  O_KIND, O_SEQ, O_CLIENT, O_REF, O_MIN, O_A, O_B, O_TSTART, O_TLEN, N_OPF
};
enum Kind {
  K_INSERT = 1, K_REMOVE = 2, K_ANNOTATE = 3, K_OBLITERATE = 4
};

constexpr int kMaxWarps = 8;     // documents per block, at most
constexpr int kGmemWarps = 1;    // documents per block in device memory
constexpr int kOpTile = 64;      // op rows staged per bulk load
constexpr int kBarWords = 4;     // the warp's mbarrier, padded to 16 bytes
constexpr unsigned kFull = 0xffffffffu;

struct FoldArgs {
  // Inputs are int32 unless the fold+export entry says otherwise
  // (op_narrow, st_mode); a narrow array is read through the same pointer.
  const int32_t* op[N_OPF];          // [D, T] each
  const int32_t* pvals;              // [D, T, K]
  const int32_t* st_in[N_FIXED];     // [D, S] each
  const int32_t* props_in;           // [D, S, K]
  const int32_t* n_in;               // [D]
  const uint8_t* ov_in;              // [D] (torch.bool)
  int32_t* st_out[N_FIXED];
  int32_t* props_out;
  int32_t* n_out;
  uint8_t* ov_out;
  int32_t* scratch;                  // [D, doc_words] (device memory)
  int D, S, T, K;
  // -- fold+export entry only --
  int op_narrow;        // 1: kind/client int8, other fields and pvals int16
  int st_mode;          // 0: cold (built here), 1: int32, 2: int16 encoding
  const int32_t* doc_base;           // [D] arena base of each document
  void* ex_out;         // [D, ex_rows, S], int16 when i16 else int32
  int32_t* misc_out;    // [D, 4] (i8 layouts)
  int32_t* digest_out;  // [D, 2], or null
  int ex_rows, i16, i8, n_fields, n_props_rows;
  int fields[N_FIXED];  // the exported slot planes, in row order
};

// int32 words of one document's working area (shared memory, or its slice
// of the device-memory scratch): mbarrier, 12 planes + props, v and cum,
// one op tile (9 fields + pvals).  Every part is a multiple of 4 words when
// S is, so every row starts 16-byte aligned.
__host__ __device__ inline size_t doc_words(int S, int K) {
  return kBarWords + (size_t)(N_FIXED + K) * S + 2 * (size_t)S
      + (size_t)(N_OPF + K) * kOpTile;
}

// -- Hopper bulk copies and mbarriers (PTX) ---------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// Order this thread's generic-proxy shared-memory accesses before the
// bulk copies (async proxy) that follow.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_addr(src)),
                  "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// -- one document, one warp -------------------------------------------------

struct Doc {
  int32_t* st;     // [N_FIXED][S] slot planes
  int32_t* props;  // [S][K]
  int32_t* vbuf;   // [S] visible length in the row's view
  int32_t* cbuf;   // [S] exclusive prefix of vbuf
  int32_t* opb;    // [N_OPF][kOpTile], then pvals [kOpTile][K]
  int S, K, lane;

  __device__ int32_t& at(int p, int s) const { return st[p * S + s]; }

  __device__ int visible(int s, int ref, int client) const {
    const bool ins_vis = at(INS_SEQ, s) <= ref || at(INS_CLIENT, s) == client;
    const int rem = at(REM_SEQ, s);
    const bool removed = rem != kNotRemoved;
    // An obliterate stamp's author is involved in the removal even when
    // another client's remove won it (merge_tree._removed_in_view).
    const bool rem_vis = rem <= ref || at(REM_CLIENT, s) == client
        || at(REM2_CLIENT, s) == client
        || (removed && (at(OB1_CLIENT, s) == client
                        || at(OB2_CLIENT, s) == client));
    return (ins_vis && !rem_vis) ? at(TLEN, s) : 0;
  }

  // Zamboni parity: a tombstone expired at the op's stamped MSN.
  __device__ bool expired(int s, int msn) const {
    const int ob1 = at(OB1_SEQ, s), ob2 = at(OB2_SEQ, s);
    const int rem = at(REM_SEQ, s);
    const bool ob1_live = ob1 != kNotRemoved && ob1 > msn;
    const bool ob2_live = ob2 != kNotRemoved && ob2 > msn;
    return rem != kNotRemoved && rem <= msn && at(INS_SEQ, s) <= msn
        && !ob1_live && !ob2_live;
  }
};

// What the row's one view found (warp-uniform).
struct View {
  int ia;    // slot split at a, or -1
  int ib;    // slot split at b (range rows), or -1
  int ja;    // first live slot with cum >= a, else n
  int vend;  // v / cum are valid for slots [0, vend)
};

// v / cum over the live slots, 32 at a time with a running carry, and the
// searches on them.  Stops after the chunk where cum reaches stop_at: no
// later slot can be split, be the tie-break slot or be stamped.
__device__ View take_view(const Doc& doc, int n, int ref, int client, int a,
                          int b, bool is_ins) {
  const int lane = doc.lane;
  const int stop_at = is_ins ? a : max(a, b);
  View w{-1, -1, -1, 0};
  int carry = 0;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int s = c0 + lane;
    const bool in = s < n;
    const int v = in ? doc.visible(s, ref, client) : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int cum = carry + incl - v;
    carry += __shfl_sync(kFull, incl, 31);
    if (in) {
      doc.vbuf[s] = v;
      doc.cbuf[s] = cum;
    }
    const unsigned in_a = __ballot_sync(kFull, in && cum < a && a < cum + v);
    if (w.ia < 0 && in_a) w.ia = c0 + __ffs(in_a) - 1;
    if (!is_ins) {
      const unsigned in_b =
          __ballot_sync(kFull, in && cum < b && b < cum + v);
      if (w.ib < 0 && in_b) w.ib = c0 + __ffs(in_b) - 1;
    }
    const unsigned ge_a = __ballot_sync(kFull, in && cum >= a);
    if (w.ja < 0 && ge_a) w.ja = c0 + __ffs(ge_a) - 1;
    w.vend = min(c0 + 32, n);
    if (__any_sync(kFull, in && cum >= stop_at)) break;
  }
  if (w.ja < 0) w.ja = n;
  return w;
}

// Obliterate-on-arrival for an insert: the new segment dies iff its
// nearest non-expired neighbours share a stamp the inserter had not seen
// from another client.  In pre-split indices the left neighbour is the
// last present slot before ja; the right one the first present slot from
// ia (the right half of a split shares ia's stamps) or from ja.
__device__ void arrival_kill(const Doc& doc, int n, const View& w, int msn,
                             int ref, int client, int& kill_seq,
                             int& kill_client) {
  const int lane = doc.lane;
  int left = -1, right = -1;
  for (int top = w.ja; top > 0 && left < 0; top -= 32) {
    const int s = top - 32 + lane;
    const unsigned m = __ballot_sync(kFull, s >= 0 && !doc.expired(s, msn));
    if (m) left = top - 32 + 31 - __clz((int)m);
  }
  for (int c0 = w.ia >= 0 ? w.ia : w.ja; c0 < n && right < 0; c0 += 32) {
    const int s = c0 + lane;
    const unsigned m = __ballot_sync(kFull, s < n && !doc.expired(s, msn));
    if (m) right = c0 + __ffs(m) - 1;
  }
  const bool has_l = left >= 0, has_r = right >= 0;
  const int l1s = has_l ? doc.at(OB1_SEQ, left) : kNotRemoved;
  const int l2s = has_l ? doc.at(OB2_SEQ, left) : kNotRemoved;
  const int l1c = has_l ? doc.at(OB1_CLIENT, left) : kNotRemoved;
  const int l2c = has_l ? doc.at(OB2_CLIENT, left) : kNotRemoved;
  const int r1s = has_r ? doc.at(OB1_SEQ, right) : kNotRemoved;
  const int r2s = has_r ? doc.at(OB2_SEQ, right) : kNotRemoved;
  auto killer = [&](int ls, int lc) {
    const bool shared = ls != kNotRemoved && (ls == r1s || ls == r2s);
    return (shared && ls > ref && lc != client) ? ls : kNotRemoved;
  };
  const int k1s = killer(l1s, l1c), k2s = killer(l2s, l2c);
  kill_seq = min(k1s, k2s);
  kill_client = k1s <= k2s ? l1c : l2c;
}

// The row as warp-uniform values.
struct Row {
  int kind, seq, client, ref, msn, a, b;
  const int32_t* pv;  // [K] in the op tile
};

// Stamp one piece (view cum c, length v) of a slot for a range row;
// x holds the slot's planes.  Returns whether the piece is covered.
__device__ __forceinline__ bool stamp_piece(int32_t (&x)[N_FIXED],
                                            const Row& r, int c, int v,
                                            bool expired, bool& over) {
  const bool covered = c >= r.a && c + v <= r.b && v > 0;
  const bool is_obl = r.kind == K_OBLITERATE;
  const bool rem_like = r.kind == K_REMOVE || is_obl;
  const int rem = x[REM_SEQ], rem2 = x[REM2_SEQ];
  bool first_win = covered && rem == kNotRemoved && rem_like;
  const bool again = covered && rem != kNotRemoved && rem_like;
  const bool second = again && rem2 == kNotRemoved;
  over |= again && rem2 != kNotRemoved;  // a third remover
  if (is_obl) {
    // Also stamp zero-width slots strictly inside the range.
    const bool obl_zero = !expired && v == 0 && c > r.a && c < r.b;
    first_win |= obl_zero && rem == kNotRemoved;
    const bool stamp = covered || obl_zero;
    const int ob1 = x[OB1_SEQ], ob2 = x[OB2_SEQ];
    const bool to_ob1 = stamp && ob1 == kNotRemoved;
    const bool to_ob2 = stamp && !to_ob1 && ob2 == kNotRemoved
        && ob1 != r.seq;
    over |= stamp && ob1 != kNotRemoved && ob2 != kNotRemoved
        && ob1 != r.seq && ob2 != r.seq;
    if (to_ob1) { x[OB1_SEQ] = r.seq; x[OB1_CLIENT] = r.client; }
    if (to_ob2) { x[OB2_SEQ] = r.seq; x[OB2_CLIENT] = r.client; }
  }
  if (first_win) { x[REM_SEQ] = r.seq; x[REM_CLIENT] = r.client; }
  if (second) { x[REM2_SEQ] = r.seq; x[REM2_CLIENT] = r.client; }
  return covered;
}

// The row's one combined move over pre-row slots [lo, hi), top down in
// 32-slot chunks: every slot is read, then written once at its final
// place, split into its pieces and (range rows) stamped.  Returns whether
// a piece overflowed (a third remover or stamp).
__device__ bool move_and_stamp(const Doc& doc, const Row& r, const View& w,
                               bool cut_a, bool cut_b, int lo, int hi) {
  const int S = doc.S, K = doc.K, lane = doc.lane;
  const bool is_ins = r.kind == K_INSERT;
  const bool is_ann = r.kind == K_ANNOTATE;
  bool over = false;
  for (int top = hi; top > lo; top -= 32) {
    const int s = top - 32 + lane;
    const bool act = s >= lo;
    int32_t x[N_FIXED];
    int np = 0, base = 0;
    int c = 0, v = 0, cut0 = 0, cut1 = 0;
    bool expired = false;
    if (act) {
#pragma unroll
      for (int p = 0; p < N_FIXED; ++p) x[p] = doc.at(p, s);
      if (s < w.vend) {
        c = doc.cbuf[s];
        v = doc.vbuf[s];
      }
      const bool sa = cut_a && s == w.ia, sb = cut_b && s == w.ib;
      np = 1 + sa + sb;
      cut0 = sa && sb ? min(r.a, r.b) : (sa ? r.a : r.b);
      cut1 = max(r.a, r.b);
      base = s + (cut_a && w.ia < s) + (cut_b && w.ib < s);
      const int msn = r.msn;
      const bool ob1_live = x[OB1_SEQ] != kNotRemoved && x[OB1_SEQ] > msn;
      const bool ob2_live = x[OB2_SEQ] != kNotRemoved && x[OB2_SEQ] > msn;
      expired = x[REM_SEQ] != kNotRemoved && x[REM_SEQ] <= msn
          && x[INS_SEQ] <= msn && !ob1_live && !ob2_live;
    }
    __syncwarp();  // the chunk is read before any of it is overwritten
    unsigned covered = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k >= np) break;
      const int start = k == 0 ? c : (k == 1 ? cut0 : cut1);
      const int end = k + 1 == np ? c + v : (k == 0 ? cut0 : cut1);
      int32_t y[N_FIXED];
#pragma unroll
      for (int p = 0; p < N_FIXED; ++p) y[p] = x[p];
      if (np > 1) {
        y[TSTART] = x[TSTART] + (start - c);
        y[TLEN] = end - start;
      }
      if (!is_ins && s < w.vend
          && stamp_piece(y, r, start, end - start, expired, over))
        covered |= 1u << k;
      const int p = base + k;
      const int dst = p + (is_ins && p >= w.ja);
      if (dst < S) {
#pragma unroll
        for (int q = 0; q < N_FIXED; ++q) doc.at(q, dst) = y[q];
      }
    }
    for (int kk = 0; kk < K; ++kk) {
      const int32_t pv0 = act ? doc.props[s * K + kk] : 0;
      __syncwarp();
      const int32_t pv = r.pv[kk];
      for (int k = 0; k < np; ++k) {
        const int p = base + k;
        const int dst = p + (is_ins && p >= w.ja);
        const bool touch = is_ann && ((covered >> k) & 1u)
            && pv != kPropNotTouched;
        if (dst < S) doc.props[dst * K + kk] = touch ? pv : pv0;
      }
    }
    __syncwarp();
  }
  return over;
}

// -- plain copies (device-memory placement, fold+export entry) -------------

__device__ __forceinline__ bool sentinel_plane(int p) {
  return p == REM_SEQ || p == REM2_SEQ || p == OB1_SEQ || p == OB2_SEQ;
}

// The value a plane holds on an empty document (cold_start's fill).
__device__ __forceinline__ int32_t plane_fill(int p) {
  if (sentinel_plane(p)) return kNotRemoved;
  if (p == INS_CLIENT || p == REM_CLIENT || p == REM2_CLIENT
      || p == OB1_CLIENT || p == OB2_CLIENT)
    return -1;
  return 0;
}

// Op rows [t0, t0 + tl) into the warp's tile with ordinary loads, lane i
// taking rows i, i + 32, ...: int32, or the narrow upload encoding widened
// (the reference's _widen_ops: sign extension, and an insert's tstart
// rebased by the document's arena base; other rows' tstart is 0).
__device__ void load_ops_plain(const Doc& doc, int32_t* pvb,
                               const FoldArgs& a, int d, int t0, int tl) {
  const size_t first = (size_t)d * a.T + t0;
  const int base = a.op_narrow ? a.doc_base[d] : 0;
  for (int i = doc.lane; i < tl; i += 32) {
    const size_t at = first + i;
    int kind = 0;
#pragma unroll
    for (int f = 0; f < N_OPF; ++f) {
      int32_t v;
      if (!a.op_narrow)
        v = a.op[f][at];
      else if (f == O_KIND || f == O_CLIENT)
        v = reinterpret_cast<const int8_t*>(a.op[f])[at];
      else
        v = reinterpret_cast<const int16_t*>(a.op[f])[at];
      if (f == O_KIND) kind = v;
      if (f == O_TSTART && a.op_narrow) v = kind == K_INSERT ? v + base : 0;
      doc.opb[f * kOpTile + i] = v;
    }
  }
  const int K = doc.K;
  for (int j = doc.lane; j < tl * K; j += 32) {
    const size_t at = first * K + j;
    pvb[j] = a.op_narrow ? reinterpret_cast<const int16_t*>(a.pvals)[at]
                         : a.pvals[at];
  }
}

// The document's state into its working area with ordinary loads; returns
// n and sets overflow.  st_mode 0 builds the empty state (the reference's
// _cold_start: no state is read), 1 reads int32, 2 reads the int16 upload
// encoding (the reference's _widen_state: tstart rebased on live slots,
// I16_NOT_REMOVED back to NOT_REMOVED in the seq planes).
__device__ int load_state_plain(const Doc& doc, const FoldArgs& a, int d,
                                bool& overflow) {
  const int S = doc.S, K = doc.K, lane = doc.lane;
  if (a.st_mode == 0) {
    for (int p = 0; p < N_FIXED; ++p) {
      const int32_t fill = plane_fill(p);
      for (int s = lane; s < S; s += 32) doc.at(p, s) = fill;
    }
    for (int i = lane; i < S * K; i += 32) doc.props[i] = kPropAbsent;
    overflow = false;
    return 0;
  }
  const bool narrow = a.st_mode == 2;
  const size_t dS = (size_t)d * S;
  const int n = narrow ? reinterpret_cast<const int16_t*>(a.n_in)[d]
                       : a.n_in[d];
  const int base = narrow ? a.doc_base[d] : 0;
  for (int p = 0; p < N_FIXED; ++p) {
    for (int s = lane; s < S; s += 32) {
      int32_t v = narrow ? reinterpret_cast<const int16_t*>(a.st_in[p])[dS + s]
                         : a.st_in[p][dS + s];
      if (narrow) {
        if (p == TSTART)
          v = s < n ? v + base : 0;
        else if (sentinel_plane(p) && v == kI16NotRemoved)
          v = kNotRemoved;
      }
      doc.at(p, s) = v;
    }
  }
  for (int i = lane; i < S * K; i += 32)
    doc.props[i] = narrow
        ? reinterpret_cast<const int16_t*>(a.props_in)[dS * K + i]
        : a.props_in[dS * K + i];
  overflow = a.ov_in[d] != 0;
  return n;
}

// -- the fold+export epilogue -----------------------------------------------

constexpr uint32_t kDigestSalt0 = 0x9E3779B9u;  // the digest's two lanes
constexpr uint32_t kDigestSalt1 = 0x85EBCA6Bu;
constexpr int kDigestPropsBase = 16;  // props column k salts at 16 + k

// splitmix-style avalanche over uint32 (the reference's _mix_u32).
__device__ __forceinline__ uint32_t mix_u32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Logical export row j at slot s: the exported slot planes (a.fields),
// then the props rows, then the misc row [n, overflow, live_len, 0, ...];
// the reference's _export_state before any byte packing.
__device__ __forceinline__ int32_t export_value(const Doc& doc,
                                                const FoldArgs& a, int j,
                                                int s, int n, int base,
                                                int live, bool overflow) {
  if (j < a.n_fields) {
    const int p = a.fields[j];
    const int32_t v = doc.at(p, s);
    if (p == TSTART) return s < n ? (a.i16 ? v - base : v) : 0;
    if (a.i16 && sentinel_plane(p) && v == kNotRemoved)
      return a.i8 ? kI8NotRemoved : kI16NotRemoved;
    return v;
  }
  j -= a.n_fields;
  if (j < a.n_props_rows) return doc.props[s * doc.K + j];
  return s == 0 ? n : (s == 1 ? (int)overflow : (s == 2 ? live : 0));
}

// Write one document's transfer rows (and digest) from its working area.
__device__ void export_doc(const Doc& doc, const FoldArgs& a, int d, int n,
                           bool overflow) {
  const int S = doc.S, K = doc.K, lane = doc.lane;
  const int nl = min(n, S);
  const int base = a.doc_base[d];
  __syncwarp();  // the fold's last writes are seen by every lane
  uint32_t live = 0, acc0 = 0, acc1 = 0;
  for (int s = lane; s < nl; s += 32) {
    if (doc.at(REM_SEQ, s) == kNotRemoved) live += doc.at(TLEN, s);
    if (a.digest_out == nullptr) continue;
    const uint32_t key = (uint32_t)s * 0x01000193u;
#pragma unroll
    for (int p = 0; p < N_FIXED; ++p) {
      const uint32_t v = (uint32_t)(doc.at(p, s) - (p == TSTART ? base : 0));
      acc0 += v * mix_u32(key + p + kDigestSalt0);
      acc1 += v * mix_u32(key + p + kDigestSalt1);
    }
    for (int k = 0; k < K; ++k) {
      // absent keys hash 0 (K-bucket invariance); set values shift by +1
      const int32_t pv = doc.props[s * K + k];
      const uint32_t v = pv != kPropAbsent ? (uint32_t)(pv + 1) : 0u;
      acc0 += v * mix_u32(key + kDigestPropsBase + k + kDigestSalt0);
      acc1 += v * mix_u32(key + kDigestPropsBase + k + kDigestSalt1);
    }
  }
  const int live_len = (int)warp_sum(live);
  const int R = a.ex_rows;
  const size_t doc_at = (size_t)d * R * S;
  if (!a.i16) {
    int32_t* out = reinterpret_cast<int32_t*>(a.ex_out) + doc_at;
    for (int r = 0; r < R; ++r)
      for (int s = lane; s < S; s += 32)
        out[(size_t)r * S + s] =
            export_value(doc, a, r, s, n, base, live_len, overflow);
  } else if (!a.i8) {
    int16_t* out = reinterpret_cast<int16_t*>(a.ex_out) + doc_at;
    for (int r = 0; r < R; ++r)
      for (int s = lane; s < S; s += 32)
        out[(size_t)r * S + s] = (int16_t)export_value(
            doc, a, r, s, n, base, live_len, overflow);
  } else {
    // Row 0 is tstart (16 bits); row r >= 1 pairs logical rows 2r - 1
    // (high byte) and 2r (low byte), a zero row padding an odd count; the
    // misc values ride the separate [D, 4] leaf.
    int16_t* out = reinterpret_cast<int16_t*>(a.ex_out) + doc_at;
    const int logical = a.n_fields + a.n_props_rows;
    for (int s = lane; s < S; s += 32)
      out[s] = (int16_t)export_value(doc, a, 0, s, n, base, live_len,
                                     overflow);
    for (int r = 1; r < R; ++r) {
      const int hi_row = 2 * r - 1, lo_row = 2 * r;
      for (int s = lane; s < S; s += 32) {
        const int32_t hi =
            export_value(doc, a, hi_row, s, n, base, live_len, overflow);
        const int32_t lo = lo_row < logical
            ? export_value(doc, a, lo_row, s, n, base, live_len, overflow)
            : 0;
        out[(size_t)r * S + s] =
            (int16_t)(uint16_t)(((hi & 0xFF) << 8) | (lo & 0xFF));
      }
    }
    if (lane < 4)
      a.misc_out[(size_t)d * 4 + lane] =
          lane == 0 ? n : (lane == 1 ? (int)overflow
                                     : (lane == 2 ? live_len : 0));
  }
  if (a.digest_out != nullptr) {
    const uint32_t s0 = warp_sum(acc0), s1 = warp_sum(acc1);
    if (lane < 2) {
      const uint32_t salt = lane == 0 ? kDigestSalt0 : kDigestSalt1;
      uint32_t acc = lane == 0 ? s0 : s1;
      acc ^= mix_u32((uint32_t)n + salt);
      acc ^= mix_u32((uint32_t)live_len * 3u + salt);
      acc ^= overflow ? 0x5BD1E995u : 0u;
      a.digest_out[(size_t)d * 2 + lane] = (int32_t)mix_u32(acc);
    }
  }
}

// -- the kernel ----------------------------------------------------------------

// kGmem: the working area is the document's slice of args.scratch (else
// shared memory); kExport: the fold+export entry (else state out).  Only
// the state-out fold in shared memory moves rows with bulk copies.
template <bool kGmem, bool kExport>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
mergetree_fold_kernel(FoldArgs args) {
  extern __shared__ __align__(16) int32_t smem[];
  constexpr bool kBulk = !kGmem && !kExport;
  const int S = args.S, T = args.T, K = args.K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d = blockIdx.x * (blockDim.x >> 5) + warp;
  if (d >= args.D) return;  // nothing below waits on other warps

  int32_t* mine = kGmem ? args.scratch + (size_t)d * doc_words(S, K)
                        : smem + (size_t)warp * doc_words(S, K);
  uint64_t* bar = reinterpret_cast<uint64_t*>(mine);
  Doc doc;
  doc.S = S;
  doc.K = K;
  doc.lane = lane;
  doc.st = mine + kBarWords;
  doc.props = doc.st + (size_t)N_FIXED * S;
  doc.vbuf = doc.props + (size_t)S * K;
  doc.cbuf = doc.vbuf + S;
  doc.opb = doc.cbuf + S;
  int32_t* pvb = doc.opb + N_OPF * kOpTile;  // [kOpTile][K]

  const size_t dS = (size_t)d * S, dT = (size_t)d * T;
  const uint32_t plane_bytes = (uint32_t)S * 4;
  const uint32_t props_bytes = (uint32_t)(S * K) * 4;
  // Bring rows [t0, t0 + tl) of the op tail (and, first, the state) in:
  // lane 0 arms the warp's mbarrier with the byte count, then each lane
  // issues one bulk copy; every lane waits on the barrier's phase.
  uint32_t parity = 0;
  auto load = [&](int t0, int tl, bool with_state) {
    const uint32_t op_bytes = (uint32_t)tl * 4;
    const uint32_t total = N_OPF * op_bytes + op_bytes * K
        + (with_state ? N_FIXED * plane_bytes + props_bytes : 0);
    fence_async_shared();
    __syncwarp();  // the previous tile is consumed
    if (lane == 0) mbar_expect_tx(bar, total);
    __syncwarp();
    if (lane < N_OPF) {
      bulk_load(doc.opb + lane * kOpTile, args.op[lane] + dT + t0, op_bytes,
                bar);
    } else if (lane == N_OPF && K > 0) {
      bulk_load(pvb, args.pvals + (dT + t0) * K, op_bytes * K, bar);
    } else if (with_state && lane > N_OPF && lane <= N_OPF + N_FIXED) {
      const int p = lane - N_OPF - 1;
      bulk_load(doc.st + (size_t)p * S, args.st_in[p] + dS, plane_bytes, bar);
    } else if (with_state && lane == N_OPF + N_FIXED + 1 && K > 0) {
      bulk_load(doc.props, args.props_in + dS * K, props_bytes, bar);
    }
    mbar_wait(bar, parity);
    parity ^= 1;
  };

  int n;
  bool overflow;
  if constexpr (kBulk) {
    if (lane == 0) mbar_init(bar);
    __syncwarp();
    n = args.n_in[d];
    overflow = args.ov_in[d] != 0;
  } else {
    n = load_state_plain(doc, args, d, overflow);
  }

  for (int t0 = 0; t0 < T; t0 += kOpTile) {
    const int tl = min(kOpTile, T - t0);
    if constexpr (kBulk) {
      load(t0, tl, t0 == 0);
    } else {
      __syncwarp();  // the previous tile is consumed
      load_ops_plain(doc, pvb, args, d, t0, tl);
      __syncwarp();  // the tile (and the state) is seen by every lane
    }
    for (int ti = 0; ti < tl; ++ti) {
      Row r;
      r.kind = doc.opb[O_KIND * kOpTile + ti];
      if (r.kind < K_INSERT || r.kind > K_OBLITERATE) continue;  // inert
      r.seq = doc.opb[O_SEQ * kOpTile + ti];
      r.client = doc.opb[O_CLIENT * kOpTile + ti];
      r.ref = doc.opb[O_REF * kOpTile + ti];
      r.msn = doc.opb[O_MIN * kOpTile + ti];
      r.a = doc.opb[O_A * kOpTile + ti];
      r.b = doc.opb[O_B * kOpTile + ti];
      r.pv = pvb + ti * K;
      const bool is_ins = r.kind == K_INSERT;
      const int nl = min(n, S);  // live slots held

      const View w = take_view(doc, nl, r.ref, r.client, r.a, r.b, is_ins);
      __syncwarp();  // v / cum are seen by every lane
      const bool cut_a = w.ia >= 0;
      const bool cut_b = !is_ins && w.ib >= 0 && !(w.ib == w.ia && r.b == r.a);

      if (is_ins) {
        int kill_seq, kill_client;
        arrival_kill(doc, nl, w, r.msn, r.ref, r.client, kill_seq,
                     kill_client);
        move_and_stamp(doc, r, w, cut_a, false, cut_a ? w.ia : w.ja, nl);
        if (lane == 0 && w.ja < S) {
          const bool killed = kill_seq != kNotRemoved;
          const int32_t fresh[N_FIXED] = {
              doc.opb[O_TSTART * kOpTile + ti],
              doc.opb[O_TLEN * kOpTile + ti], r.seq, r.client,
              killed ? kill_seq : kNotRemoved, killed ? kill_client : -1,
              kNotRemoved, -1,
              killed ? kill_seq : kNotRemoved, killed ? kill_client : -1,
              kNotRemoved, -1};
#pragma unroll
          for (int p = 0; p < N_FIXED; ++p) doc.at(p, w.ja) = fresh[p];
          for (int k = 0; k < K; ++k) {
            const int32_t pv = r.pv[k];
            doc.props[w.ja * K + k] = pv == kPropNotTouched ? kPropAbsent : pv;
          }
        }
        __syncwarp();
        n += 1 + cut_a;
      } else {
        int lo = w.ja;
        if (cut_a) lo = min(lo, w.ia);
        if (cut_b) lo = min(lo, w.ib);
        const int hi = (cut_a || cut_b) ? nl : w.vend;
        const bool over = move_and_stamp(doc, r, w, cut_a, cut_b, lo, hi);
        overflow |= __any_sync(kFull, over) != 0;
        n += cut_a + cut_b;
      }
    }
  }

  if constexpr (kExport) {
    export_doc(doc, args, d, n, overflow);
  } else if constexpr (kBulk) {
    // State out: each lane sends one row back with a bulk copy.
    fence_async_shared();
    __syncwarp();
    if (lane < N_FIXED) {
      bulk_store(args.st_out[lane] + dS, doc.st + (size_t)lane * S,
                 plane_bytes);
    } else if (lane == N_FIXED && K > 0) {
      bulk_store(args.props_out + dS * K, doc.props, props_bytes);
    } else if (lane == 31) {
      args.n_out[d] = n;
      args.ov_out[d] = overflow ? 1 : 0;
    }
  } else {
    // State out with plain coalesced copies.
    __syncwarp();
    for (int p = 0; p < N_FIXED; ++p)
      for (int s = lane; s < S; s += 32) args.st_out[p][dS + s] = doc.at(p, s);
    for (int i = lane; i < S * K; i += 32)
      args.props_out[dS * K + i] = doc.props[i];
    if (lane == 0) {
      args.n_out[d] = n;
      args.ov_out[d] = overflow ? 1 : 0;
    }
  }
}

// The four builds of the kernel, by variant = kGmem | kExport << 1.
const void* kernel_of(int variant) {
  switch (variant) {
    case 0: return reinterpret_cast<const void*>(
        &mergetree_fold_kernel<false, false>);
    case 1: return reinterpret_cast<const void*>(
        &mergetree_fold_kernel<true, false>);
    case 2: return reinterpret_cast<const void*>(
        &mergetree_fold_kernel<false, true>);
    default: return reinterpret_cast<const void*>(
        &mergetree_fold_kernel<true, true>);
  }
}

// Documents per block: in shared memory, the W of 1, 2, 4, 8 that keeps
// the most documents resident per SM (smaller W on a tie), and the blocks
// per SM that gives; in device memory, kGmemWarps and no shared memory.
struct LaunchShape {
  int warps, blocks_per_sm;
  size_t bytes;
};

// Launch shapes already found, per (device, variant, S, K), so the
// attribute calls and occupancy queries run once per key and not on every
// launch.
struct ShapeEntry {
  int dev, variant, S, K;
  LaunchShape shape;
};
std::mutex g_shapes_mu;
std::vector<ShapeEntry> g_shapes;

cudaError_t find_launch_shape(int dev, int variant, int S, int K,
                              LaunchShape* out) {
  const void* kernel = kernel_of(variant);
  cudaError_t e;
  if (variant & 1) {
    // Device memory: no shared memory, so give the SM's memory to L1.
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             0);
    if (e != cudaSuccess) return e;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kGmemWarps * 32, 0);
    if (e != cudaSuccess) return e;
    if (blocks == 0) return cudaErrorInvalidConfiguration;
    *out = LaunchShape{kGmemWarps, blocks, 0};
    return cudaSuccess;
  }
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const size_t per_doc = doc_words(S, K) * sizeof(int32_t);
  LaunchShape best{0, 0, 0};
  for (int w = 1; w <= kMaxWarps; w *= 2) {
    const size_t bytes = w * per_doc;
    if (bytes > (size_t)optin) break;
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, w * 32,
                                                      bytes);
    if (e != cudaSuccess) return e;
    if (blocks * w > best.blocks_per_sm * best.warps)
      best = LaunchShape{w, blocks, bytes};
  }
  if (best.warps == 0) return cudaErrorInvalidConfiguration;
  *out = best;
  return cudaSuccess;
}

cudaError_t launch_shape(int variant, int S, int K, LaunchShape* out) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(g_shapes_mu);
  for (const ShapeEntry& c : g_shapes) {
    if (c.dev == dev && c.variant == variant && c.S == S && c.K == K) {
      *out = c.shape;
      return cudaSuccess;
    }
  }
  e = find_launch_shape(dev, variant, S, K, out);
  if (e == cudaSuccess)
    g_shapes.push_back(ShapeEntry{dev, variant, S, K, *out});
  return e;
}

template <bool kGmem, bool kExport>
int launch(const FoldArgs& args, void* stream) {
  if (args.D == 0) return 0;
  LaunchShape shape;
  const cudaError_t e = launch_shape((kGmem ? 1 : 0) | (kExport ? 2 : 0),
                                     args.S, args.K, &shape);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (args.D + shape.warps - 1) / shape.warps;
  mergetree_fold_kernel<kGmem, kExport>
      <<<blocks, shape.warps * 32, shape.bytes, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

// The state-out entries' pointers: the FoldArgs pointers in declaration
// order (9 op fields, pvals, 12 state planes, props, n, overflow, then the
// same 15 outputs).
FoldArgs state_out_args(void* const* ptrs, int D, int S, int T, int K) {
  FoldArgs args = {};
  int i = 0;
  for (int f = 0; f < N_OPF; ++f) args.op[f] = (const int32_t*)ptrs[i++];
  args.pvals = (const int32_t*)ptrs[i++];
  for (int p = 0; p < N_FIXED; ++p) args.st_in[p] = (const int32_t*)ptrs[i++];
  args.props_in = (const int32_t*)ptrs[i++];
  args.n_in = (const int32_t*)ptrs[i++];
  args.ov_in = (const uint8_t*)ptrs[i++];
  for (int p = 0; p < N_FIXED; ++p) args.st_out[p] = (int32_t*)ptrs[i++];
  args.props_out = (int32_t*)ptrs[i++];
  args.n_out = (int32_t*)ptrs[i++];
  args.ov_out = (uint8_t*)ptrs[i++];
  args.D = D;
  args.S = S;
  args.T = T;
  args.K = K;
  args.st_mode = 1;  // int32 state in (the plain loads of device memory)
  return args;
}

}  // namespace

extern "C" {

// Working-area bytes one document needs for S slots and K props keys: its
// shared memory, or its slice of the device-memory scratch.
long long mergetree_fold_smem_bytes(int S, int K) {
  return (long long)(doc_words(S, K) * sizeof(int32_t));
}

// The launch a build of the kernel takes at (S, K) on the current device:
// cudaOccupancyMaxActiveBlocksPerMultiprocessor for it, with the documents
// (warps) per block in *docs_per_block.  variant = device memory (1) |
// fold+export (2), 0-3.  Returns blocks per SM, or minus the CUDA error.
int mergetree_fold_occupancy_of(int variant, int S, int K,
                                int* docs_per_block) {
  if (variant < 0 || variant > 3) return -(int)cudaErrorInvalidValue;
  LaunchShape shape;
  const cudaError_t e = launch_shape(variant, S, K, &shape);
  if (e != cudaSuccess) return -(int)e;
  *docs_per_block = shape.warps;
  return shape.blocks_per_sm;
}

// State out, shared memory.  Returns cudaGetLastError() after the launch
// (0 = launched).
int mergetree_fold(void* const* ptrs, int D, int S, int T, int K,
                   void* stream) {
  return launch<false, false>(state_out_args(ptrs, D, S, T, K), stream);
}

// State out, device memory: scratch is [D, mergetree_fold_smem_bytes / 4]
// int32.
int mergetree_fold_gmem(void* const* ptrs, int D, int S, int T, int K,
                        int32_t* scratch, void* stream) {
  FoldArgs args = state_out_args(ptrs, D, S, T, K);
  args.scratch = scratch;
  return launch<true, false>(args, stream);
}

// Fold + export.  ptrs: 9 op fields, pvals, 12 state planes, props, n,
// overflow (null state pointers when cold), doc_base, the export buffer,
// the misc leaf (i8 layouts, else null), the digest (or null), the scratch
// (device memory, else null).  iargs: D, S, T, K, op_narrow, st_mode,
// ex_rows, i16, i8, n_props_rows, n_fields, then the n_fields exported
// plane indices.  gmem picks the placement.
int mergetree_fold_export(void* const* ptrs, const int* iargs, int gmem,
                          void* stream) {
  FoldArgs args = {};
  int i = 0;
  for (int f = 0; f < N_OPF; ++f) args.op[f] = (const int32_t*)ptrs[i++];
  args.pvals = (const int32_t*)ptrs[i++];
  for (int p = 0; p < N_FIXED; ++p) args.st_in[p] = (const int32_t*)ptrs[i++];
  args.props_in = (const int32_t*)ptrs[i++];
  args.n_in = (const int32_t*)ptrs[i++];
  args.ov_in = (const uint8_t*)ptrs[i++];
  args.doc_base = (const int32_t*)ptrs[i++];
  args.ex_out = ptrs[i++];
  args.misc_out = (int32_t*)ptrs[i++];
  args.digest_out = (int32_t*)ptrs[i++];
  args.scratch = (int32_t*)ptrs[i++];
  args.D = iargs[0];
  args.S = iargs[1];
  args.T = iargs[2];
  args.K = iargs[3];
  args.op_narrow = iargs[4];
  args.st_mode = iargs[5];
  args.ex_rows = iargs[6];
  args.i16 = iargs[7];
  args.i8 = iargs[8];
  args.n_props_rows = iargs[9];
  args.n_fields = iargs[10];
  if (args.n_fields < 1 || args.n_fields > N_FIXED)
    return (int)cudaErrorInvalidValue;
  for (int f = 0; f < args.n_fields; ++f) {
    args.fields[f] = iargs[11 + f];
    if (args.fields[f] < 0 || args.fields[f] >= N_FIXED)
      return (int)cudaErrorInvalidValue;
  }
  return gmem ? launch<true, true>(args, stream)
              : launch<false, true>(args, stream);
}

}  // extern "C"
