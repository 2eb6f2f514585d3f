// The SharedTree edit-fold (K5) for Hopper (sm_90a), with the tier-0
// forest digest fused into its epilogue.
//
// Replaces the reference's XLA-traced device code K5:
// fluidframework_tpu/ops/tree_kernel.py `_apply_edit` (:137, with
// `_splice_after` :87, `_detach` :104, `_in_subtree` :115) under
// `replay_vmapped` (:222), and fluidframework_tpu/ops/tree_pipeline.py
// `tree_doc_digests` (:109).  The wrapper is ops/tree_fold_cuda.py; the
// plain PyTorch versions (tree_kernel.tree_fold_reference,
// tree_pipeline.tree_doc_digests) are the CPU path and the card's
// yardstick.
//
// What it computes, per document d: the edit rows t = 0..T-1 applied in
// order to the forest planes (TreeState field order: head[C], next[N],
// prev[N], node_container[N], container_parent[C], value[N],
// value_seq[N], insert_seq[N], removed_seq[N], overflow), written to new
// output planes (the inputs are never written: a resident chunk is folded
// again on its next exact hit).  With kDigest, the [D, 2] int32 digest of
// the final forest: per lane salt, the uint32 sum over used rows
// (i < n_nodes[d] / i < n_cont[d]) of (plane ^ 0xA5A5A5A5) times a
// position- and plane-salted weight, then n_nodes, n_cont and overflow
// mixed in.  uint32 arithmetic wraps, as the reference's does.
//
// Index rules (the reference's, under XLA): a read at a negative index
// counts from the end and then clamps into the plane; a write does the
// same count and is dropped outside the plane.  The fold reads and writes
// at NIL = -1 without a mask in three places (the expiry of a NIL
// destination owner, the head slot of an unlinked target's container,
// the gathers before a select), so `rd` / `wr` below apply exactly those
// rules.  Within one edit the writes go in the reference's order, and
// where two indices alias the last write wins.
//
// What bounds it on this card: the dependent chain of the slowest
// document, not bytes or operations.  A chunk of 1,024 documents is one
// wave (every document resident at once), so the kernel takes as long as
// its longest document: a sequence of scalar reads and writes, one
// thread's work (an insert reads four words and writes up to five; a move
// walks up to 64 ancestors).  tools/torch_kernel_turns.py's clock64()
// builds showed, on an H100 (700 W), how long each link of that chain
// was: in an earlier design of this file (one warp a document, planes
// copied in by strided loops, each edit row handed to lane 0 by eight
// shuffles) the slowest document took 158,464 cycles, the kernel's whole
// 0.082 ms, at ~490 cycles an applied row, ~170 a row's delivery and
// ~180 a walk step.  Moving the rows and a parent table into shared
// memory cut the walk but not the rows (~560 + ~190 cycles): the chain
// was lane 0's instruction stream itself (every index put through the
// read or write rule, a branch round every store, a jump table for the
// kind), not memory latency.
//
// Design: the chain made short, and nothing else on it.
//   - One warp a document.  Its first lanes issue bulk asynchronous copies
//     (cp.async.bulk global -> shared, on the warp's mbarrier) of the nine
//     forest planes and the first kTile rows of the eight edit planes,
//     all in flight at once; every lane waits on the barrier.
//   - The warp decodes each tile of edit rows in parallel into row-major
//     records (kRowWords words a row): the row's eight fields and every
//     index the row uses already put through the read rule (ja, jc, jf)
//     and the write rule (wa, wc, wf, wt; -1 = dropped).
//   - Lane 0 folds alone: four 16-byte shared loads bring a row (the next
//     row's are issued before the current one applies), an if-chain
//     picks the kind, and each kind is straight-line code: its reads
//     first, then selects, then predicated stores in the reference's
//     order.  Only values read from the forest still go through the rules.
//   - The ancestor walk runs over a table of (next entry's shared
//     address, raw owner) pairs, one per node plus two sentinels: a node
//     whose container is NIL leads to STOP, one whose container's owner is
//     NIL leads to NILSTATE (compared once, then STOP), STOP leads to
//     itself.  A step is one 8-byte shared load whose result is the next
//     step's address; the hit test and the step count ride beside it, and
//     the loop leaves every kWalkUnroll steps.  container_parent never
//     changes in the fold and node_container changes only in a move, so a
//     move rewrites one entry.
//   - The planes go back with bulk copies shared -> global, and the warp
//     forms the digest from shared memory while they drain.
//   - One warp, one document, a block: a block's shared memory is one
//     document's working area, so the card holds as many documents at once
//     as there are working areas to fit (13 an SM at the pinned chunk's
//     16,480 bytes, 1,716 in all: a 1,024-document chunk is one wave), and
//     they spread over every SM and scheduler.
// Measured with tools/torch_kernel_turns.py on an H100 (700 W) at the
// pinned chunk (1,024 documents, N = 256, C = 128, T = 64): 0.0315 ms
// state out and 0.0323 ms with the digest, against 0.0831 / 0.0845 ms for
// the earlier design in the same process, bit for bit equal.  The slowest
// document now takes 58,857 cycles; a document's mean is 33,291: the copy
// in, decode and walk table 26%, lane 0's reads of its rows 18%, the rows'
// apply 42% (~335 cycles a row), the walk 9% (~59 cycles a step, the
// steps the plain fold counts), the write-back 4%.  The copies alone (no
// row folded) take 0.0145 ms, the bytes bound is 0.0056 ms.
// Shapes whose rows are not whole 16-byte units (N, C or T not a multiple
// of 4, or a plane not 16-byte aligned) copy with plain coalesced loads
// instead; the fold is the same.  A forest too wide for the walk table and
// a kTile-row tile beside it (N = 8,192 with C <= 256, as the packer pads
// a chunk to its widest document) takes the lean layout (smem_layout): no
// walk table, the walk reading the shared planes as the reference loops,
// and the most edit rows a tile (a multiple of 4) that still fit.  So
// every forest that fits a block alone, which the earlier design folded in
// shared memory, still folds there.  A document whose working set fits in
// neither layout folds in its slice of the output planes in device memory
// (kGmem): the same row code over global pointers, the edit rows still
// staged and decoded in shared memory, the walk reading node_container and
// container_parent directly.  Nothing is refused for size.
//
// A launch runs on the stream it is given and does not synchronise; the
// entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

// The block's dynamic shared memory: its document's working area.
extern __shared__ __align__(16) int smem[];

namespace {

constexpr int kNil = -1;
constexpr int kNotRemoved = INT_MAX;
constexpr int kMaxDepth = 64;  // tree_kernel.MAX_DEPTH
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 64;             // edit rows staged at a time
constexpr int kRowWords = 16;         // a decoded row
constexpr int kBarWords = 4;          // the warp's mbarrier, 16 bytes
constexpr int kWalkUnroll = 4;        // walk steps between exit tests

// edit kinds (tree_kernel.K_*)
constexpr int kInsert = 1, kRemove = 2, kSet = 3, kMove = 4;

// forest planes in TreeState field order (overflow rides apart)
enum {
  kHead, kNext, kPrev, kNodeCont, kContParent, kValue, kValueSeq,
  kInsertSeq, kRemovedSeq, kPlanes
};
// edit planes in TreeEdits field order
enum { eKind, eSeq, eContainer, eAnchor, eFirst, eTail, eValue, ePurge,
       kEditPlanes };

// digest constants (tree_pipeline: _DIGEST_NODE_PLANES, _CONT_SALT_BASE,
// _ACTIVE_XOR, the lane salts)
constexpr uint32_t kContSaltBase = 8;
constexpr uint32_t kActiveXor = 0xA5A5A5A5u;
constexpr uint32_t kSalt0 = 0x9E3779B9u, kSalt1 = 0x85EBCA6Bu;
constexpr uint32_t kOverflowMix = 0x5BD1E995u;

struct Args {
  const int* in[kPlanes];
  const uint8_t* in_overflow;
  const int* edits[kEditPlanes];
  int* out[kPlanes];
  uint8_t* out_overflow;
  const int* n_nodes;
  const int* n_cont;
  int* digest;  // [D, 2]
  int D, N, C, T;
  int tile;     // edit rows staged at a time (kTile in device memory)
  bool table;   // the walk table in shared memory
  bool bulk;    // every row a whole number of 16-byte units, aligned
};

__host__ __device__ __forceinline__ bool container_axis(int p) {
  return p == kHead || p == kContParent;
}

// Word offset of plane p in a document's forest (planes back to back).
__host__ __device__ __forceinline__ int plane_offset(int p, int N, int C) {
  const int conts = (p > kHead) + (p > kContParent);
  return (p - conts) * N + conts * C;
}

// A document's working area (int32 words from the block's start): the
// mbarrier, the raw edit tile [kEditPlanes][tile], the decoded rows
// [tile + 1][kRowWords] (the last one only ever read ahead), and in the
// shared-memory placement the forest and, when it fits, the walk table
// [N + 2][2].  `tile` is kTile, or fewer rows (a multiple of 4) in the
// lean layout (smem_layout).  Every part starts 16-byte aligned: the
// forest at 20 + 24 * tile words.
constexpr int kTileWord = kBarWords;
constexpr int kSmemLimit = 232448;  // a block's shared memory (bytes)

__host__ __device__ __forceinline__ int rows_word(int tile) {
  return kTileWord + kEditPlanes * tile;
}

__host__ __device__ __forceinline__ int forest_word(int tile) {
  return rows_word(tile) + kRowWords * (tile + 1);
}

__host__ __device__ __forceinline__ long long walk_word(int N, int C,
                                                        int tile) {
  return forest_word(tile) + (7LL * N + 2LL * C + 1) / 2 * 2;
}

// int32 words of one document's working area, a multiple of 4 (16-byte
// units).
__host__ __device__ __forceinline__ long long doc_words(int N, int C,
                                                        bool gmem, int tile,
                                                        bool table) {
  const long long w = gmem ? forest_word(tile)
      : walk_word(N, C, tile) + (table ? 2LL * (N + 2) : 0);
  return (w + 3) / 4 * 4;
}

// The shared-memory layout of an N x C forest: kTile rows and the walk
// table when both fit a block beside it; else the lean layout, no walk
// table and the most rows (a multiple of 4) that fit; tile 0 when none
// does (the forest then folds in device memory).
void smem_layout(int N, int C, int* tile, bool* table) {
  *table = true;
  *tile = kTile;
  if (doc_words(N, C, false, kTile, true) * 4 <= kSmemLimit) return;
  *table = false;
  for (; *tile >= 4; *tile -= 4)
    if (doc_words(N, C, false, *tile, false) * 4 <= kSmemLimit) return;
  *tile = 0;
}

// The read rule: count a negative index from the end, then clamp.
__device__ __forceinline__ int rd(int i, int n) {
  if (i < 0) i += n;
  return min(max(i, 0), n - 1);
}

// The write rule: count a negative index from the end; -1 = dropped.
__device__ __forceinline__ int wr(int i, int n) {
  if (i < 0) i += n;
  return (unsigned)i < (unsigned)n ? i : -1;
}

// A decoded edit row: the fields, then the indices it uses under the
// read rule (j*) and the write rule (w*).
struct __align__(16) Row {
  int kind, seq, c, anchor, first, tail, value, purge;
  int ja, jc, jf, wa, wc, wf, wt, unused;
};

// A document's forest in shared memory: word offsets into `smem`, and
// the walk table's shared address.
struct SmemForest {
  int off[kPlanes];
  int N, C;
  int walk;           // word offset of the walk table, -1 without one
  uint32_t walk_at;   // its shared address
  __device__ __forceinline__ int ld(int p, int j) const {
    return smem[off[p] + j];
  }
  __device__ __forceinline__ void st(int p, int j, int v) const {
    smem[off[p] + j] = v;
  }
};

// A document's forest in device memory: its slice of the output planes.
struct GmemForest {
  int* ptr[kPlanes];
  int N, C;
  __device__ __forceinline__ int ld(int p, int j) const { return ptr[p][j]; }
  __device__ __forceinline__ void st(int p, int j, int v) const {
    ptr[p][j] = v;
  }
};

// plane[j] = v where j is a write-rule index (-1 = dropped) and `when`.
template <class F>
__device__ __forceinline__ void st_if(const F& f, bool when, int p, int j,
                                      int v) {
  if (when & (j >= 0)) f.st(p, j, v);
}

__device__ __forceinline__ bool expired(int removed_seq, int purge) {
  return (removed_seq != kNotRemoved) & (removed_seq <= purge);
}

// tree_kernel._splice_after's writes, in its order: link [first..tail]
// into container c after the anchor (`use`) or at the head; `old` is the
// anchor's successor or the container's head, read by the caller.
template <class F>
__device__ __forceinline__ void link(const F& f, bool use, int old,
                                     const Row& r, int tail, int wt) {
  st_if(f, true, kNext, wt, old);
  st_if(f, old != kNil, kPrev, wr(old, f.N), tail);
  st_if(f, use, kNext, r.wa, r.first);
  st_if(f, true, kPrev, r.wf, use ? r.anchor : kNil);
  st_if(f, !use, kHead, r.wc, r.first);
}

// The walk table's entries (shared addresses): node j, then NILSTATE
// (the walk met a NIL owner) and STOP.
__device__ __forceinline__ uint32_t walk_entry(const SmemForest& f, int e) {
  return f.walk_at + 8u * (uint32_t)e;
}

// Node j's entry: where the walk goes after j and the raw owner it meets.
__device__ __forceinline__ void set_walk(const SmemForest& f, int j, int nc,
                                         int owner) {
  const int next = nc == kNil ? f.N + 1
      : owner == kNil ? f.N : rd(owner, f.N);
  smem[f.walk + 2 * j] = (int)walk_entry(f, next);
  smem[f.walk + 2 * j + 1] = owner;
}

// tree_kernel._in_subtree from `owner` as the reference loops it, two
// dependent plane reads a step: does the walk meet `first`, and is it
// still going after kMaxDepth steps (the root not reached)?
template <class F>
__device__ __forceinline__ void plane_walk(const F& f, int owner, int first,
                                           bool& hit, bool& alive) {
  hit = false;
  alive = true;
  int cur = owner;
  for (int k = 0; k < kMaxDepth && alive; ++k) {
    hit |= cur == first;
    const int cc = cur != kNil ? f.ld(kNodeCont, rd(cur, f.N)) : kNil;
    cur = cc != kNil ? f.ld(kContParent, rd(cc, f.C)) : kNil;
    alive = cc != kNil;
  }
}

// The same walk in shared memory: with the walk table, one 8-byte load a
// step (see the header note; entries past the end lead to STOP, which
// leads to itself), else over the planes.
__device__ __forceinline__ void walk(const SmemForest& f, int owner, int jo,
                                     int first, bool& hit, bool& alive) {
  if (f.walk < 0) {
    plane_walk(f, owner, first, hit, alive);
    return;
  }
  const uint32_t stop = walk_entry(f, f.N + 1);
  uint32_t at = walk_entry(f, owner == kNil ? f.N : jo);
  int cur = owner;
  bool live = true;
  hit = false;
#pragma unroll 1
  for (int k = 0; k < kMaxDepth; k += kWalkUnroll) {
#pragma unroll
    for (int u = 0; u < kWalkUnroll; ++u) {
      hit |= live & (cur == first);
      uint32_t next;
      int raw;
      asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
                   : "=r"(next), "=r"(raw) : "r"(at) : "memory");
      live &= next != stop;
      at = next;
      cur = raw;
    }
    if (!live) break;
  }
  alive = live;
}

// In device memory: over the planes.
__device__ __forceinline__ void walk(const GmemForest& f, int owner, int,
                                     int first, bool& hit, bool& alive) {
  plane_walk(f, owner, first, hit, alive);
}

// A move set node_container[first] = c: rewrite first's walk entry.
__device__ __forceinline__ void moved(const SmemForest& f, const Row& r,
                                      int owner) {
  if ((r.wf >= 0) & (f.walk >= 0)) set_walk(f, r.wf, r.c, owner);
}

__device__ __forceinline__ void moved(const GmemForest&, const Row&, int) {}

// One edit row (tree_kernel._apply_edit); returns the row's overflow bit.
template <class F>
__device__ __forceinline__ bool apply_edit(const F& f, const Row& r) {
  if (r.kind == kInsert) {
    // an expired anchor, or one not in c, falls back to the field start
    const int rs = f.ld(kRemovedSeq, r.ja);
    const int nca = f.ld(kNodeCont, r.ja);
    const int nxa = f.ld(kNext, r.ja);
    const int head = f.ld(kHead, r.jc);
    const bool use = (r.anchor != kNil) & !expired(rs, r.purge)
        & (nca == r.c);
    link(f, use, use ? nxa : head, r, r.tail, r.wt);
    return false;
  }
  if (r.kind == kSet) {
    st_if(f, true, kValue, r.wf, r.value);
    st_if(f, true, kValueSeq, r.wf, r.seq);
    return false;
  }
  if (r.kind == kRemove) {  // the first remover wins the tombstone
    st_if(f, f.ld(kRemovedSeq, r.jf) == kNotRemoved, kRemovedSeq, r.wf,
          r.seq);
    return false;
  }
  if (r.kind != kMove) return false;
  // the reads before the row's first write: the destination's owner,
  // the purge gates, the target's links; then the cycle walk
  const int owner = f.ld(kContParent, r.jc);
  const int jo = rd(owner, f.N);
  const int rs_first = f.ld(kRemovedSeq, r.jf);
  const int p = f.ld(kPrev, r.jf);
  const int nx = f.ld(kNext, r.jf);
  const int c_old = f.ld(kNodeCont, r.jf);
  const int rs_anchor = f.ld(kRemovedSeq, r.ja);
  const int rs_owner = f.ld(kRemovedSeq, jo);
  bool hit, alive;
  walk(f, owner, jo, r.first, hit, alive);
  if (!hit & !expired(rs_first, r.purge) & !expired(rs_owner, r.purge)) {
    // an anchor at the target itself, or expired, falls back to the start
    const bool anchored = (r.anchor != kNil) & (r.anchor != r.first)
        & !expired(rs_anchor, r.purge);
    // detach (tree_kernel._detach)
    st_if(f, p == kNil, kHead, wr(c_old, f.C), nx);
    st_if(f, p != kNil, kNext, wr(p, f.N), nx);
    st_if(f, nx != kNil, kPrev, wr(nx, f.N), p);
    // splice after the detach: its reads see the detach's writes
    const int nca = f.ld(kNodeCont, r.ja);
    const int nxa = f.ld(kNext, r.ja);
    const int head = f.ld(kHead, r.jc);
    const bool use = anchored & (nca == r.c);
    link(f, use, use ? nxa : head, r, r.first, r.wf);
    st_if(f, true, kNodeCont, r.wf, r.c);
    st_if(f, true, kInsertSeq, r.wf, r.seq);
    moved(f, r, owner);
  }
  return alive;
}

// mergetree_kernel._mix_u32 / tree_pipeline's weights
__device__ __forceinline__ uint32_t mix_u32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// The digest's k-th node plane (next, prev, node_container, value,
// value_seq, insert_seq, removed_seq: every node plane, in field order)
// and k-th container plane (head, container_parent).
__device__ __forceinline__ int node_digest_plane(int k) {
  return k < 3 ? kNext + k : kValue + (k - 3);
}
__device__ __forceinline__ int cont_digest_plane(int k) {
  return k == 0 ? kHead : kContParent;
}

template <class F>
__device__ void write_digest(const F& f, const Args& a, int d, int lane,
                             bool overflow) {
  const int N = f.N, C = f.C;
  const int nn = a.n_nodes[d], nc = a.n_cont[d];
  uint32_t acc0 = 0, acc1 = 0;
  for (int i = lane; i < N && i < nn; i += kWarp) {
    const uint32_t pos = (uint32_t)i * 0x01000193u;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const uint32_t v = (uint32_t)f.ld(node_digest_plane(k), i) ^ kActiveXor;
      acc0 += v * mix_u32(pos + (uint32_t)k + kSalt0);
      acc1 += v * mix_u32(pos + (uint32_t)k + kSalt1);
    }
  }
  for (int i = lane; i < C && i < nc; i += kWarp) {
    const uint32_t pos = (uint32_t)i * 0x01000193u;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint32_t v = (uint32_t)f.ld(cont_digest_plane(k), i) ^ kActiveXor;
      acc0 += v * mix_u32(pos + kContSaltBase + (uint32_t)k + kSalt0);
      acc1 += v * mix_u32(pos + kContSaltBase + (uint32_t)k + kSalt1);
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    acc0 += __shfl_xor_sync(kFull, acc0, off);
    acc1 += __shfl_xor_sync(kFull, acc1, off);
  }
  if (lane == 0) {
    const uint32_t ov = overflow ? kOverflowMix : 0u;
    acc0 ^= mix_u32((uint32_t)nn + kSalt0) ^ mix_u32((uint32_t)nc * 3u + kSalt0) ^ ov;
    acc1 ^= mix_u32((uint32_t)nn + kSalt1) ^ mix_u32((uint32_t)nc * 3u + kSalt1) ^ ov;
    a.digest[(size_t)d * 2] = (int)mix_u32(acc0);
    a.digest[(size_t)d * 2 + 1] = (int)mix_u32(acc1);
  }
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

// Start a bulk copy shared -> global; bulk_store_wait() waits for this
// thread's copies.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_addr(src)),
                  "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}


// -- the kernel ----------------------------------------------------------------

// Decode rows [0, rows) of the raw tile (`tile` rows a plane) into Row
// records from word `rows_at` on (the warp, in parallel).
__device__ __forceinline__ void decode_rows(int rows, int tile, int rows_at,
                                            int N, int C, int lane) {
  const int* raw = smem + kTileWord;
  for (int t = lane; t < rows; t += kWarp) {
    Row r;
    r.kind = raw[eKind * tile + t];
    r.seq = raw[eSeq * tile + t];
    r.c = raw[eContainer * tile + t];
    r.anchor = raw[eAnchor * tile + t];
    r.first = raw[eFirst * tile + t];
    r.tail = raw[eTail * tile + t];
    r.value = raw[eValue * tile + t];
    r.purge = raw[ePurge * tile + t];
    r.ja = rd(r.anchor, N);
    r.jc = rd(r.c, C);
    r.jf = rd(r.first, N);
    r.wa = wr(r.anchor, N);
    r.wc = wr(r.c, C);
    r.wf = wr(r.first, N);
    r.wt = wr(r.tail, N);
    r.unused = 0;
    *reinterpret_cast<Row*>(smem + rows_at + kRowWords * t) = r;
  }
}

__device__ __forceinline__ Row row_at(int rows_at, int t) {
  return *reinterpret_cast<const Row*>(smem + rows_at + kRowWords * t);
}

// kGmem: fold in the output planes (else shared memory); kDigest: write
// the [D, 2] digest too.
template <bool kGmem, bool kDigest>
__global__ void __launch_bounds__(kWarp)
tree_fold_kernel(const Args a) {
  static_assert(sizeof(Row) == kRowWords * sizeof(int), "a row's words");
  const int lane = threadIdx.x;
  const int d = blockIdx.x;
  const int N = a.N, C = a.C, T = a.T;
  const int tile = kGmem ? kTile : a.tile;  // edit rows staged at a time
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int raw = kTileWord;  // [kEditPlanes][tile]
  const int rows_at = rows_word(tile);
  const int forest = forest_word(tile);
  const bool bulk = !kGmem && a.bulk;

  using Forest = typename std::conditional<kGmem, GmemForest,
                                           SmemForest>::type;
  Forest f;
  f.N = N;
  f.C = C;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    if constexpr (kGmem) {
      f.ptr[p] = a.out[p] + (size_t)d * (container_axis(p) ? C : N);
    } else {
      f.off[p] = forest + plane_offset(p, N, C);
    }
  }
  if constexpr (!kGmem) {
    f.walk = a.table ? (int)walk_word(N, C, tile) : -1;
    f.walk_at = a.table
        ? (uint32_t)__cvta_generic_to_shared(smem + f.walk) : 0u;
  }

  // Bring edit rows [t0, t0 + tile) in, and first the forest too, then
  // decode them: with bulk copies, lane 0 arms the barrier with the byte
  // count and the first lanes each issue one copy (8 edit planes, 9
  // forest planes); otherwise the warp copies with coalesced loads.
  uint32_t parity = 0;
  if (bulk && lane == 0) mbar_init(bar);
  __syncwarp();
  auto load = [&](int t0, bool with_forest) {
    const int rows = min(tile, T - t0);
    const size_t row0 = (size_t)d * T + t0;
    if (bulk) {
      const uint32_t row_bytes = rows > 0 ? (uint32_t)rows * 4 : 0;
      const uint32_t total = kEditPlanes * row_bytes
          + (with_forest ? (uint32_t)(7 * N + 2 * C) * 4 : 0);
      fence_async_shared();
      __syncwarp();  // the previous tile is consumed
      if (lane == 0) mbar_expect_tx(bar, total);
      __syncwarp();
      if (lane < kEditPlanes) {
        if (row_bytes)
          bulk_load(smem + raw + lane * tile, a.edits[lane] + row0,
                    row_bytes, bar);
      } else if (with_forest && lane < kEditPlanes + kPlanes) {
        const int p = lane - kEditPlanes;
        const int wd = container_axis(p) ? C : N;
        bulk_load(smem + forest + plane_offset(p, N, C),
                  a.in[p] + (size_t)d * wd, (uint32_t)wd * 4, bar);
      }
      mbar_wait(bar, parity);
      parity ^= 1;
    } else {
      __syncwarp();  // the previous tile is consumed
#pragma unroll
      for (int k = 0; k < kEditPlanes; ++k)
        for (int t = lane; t < rows; t += kWarp)
          smem[raw + k * tile + t] = a.edits[k][row0 + t];
      if (with_forest) {
#pragma unroll
        for (int p = 0; p < kPlanes; ++p) {
          const int wd = container_axis(p) ? C : N;
          const int* src = a.in[p] + (size_t)d * wd;
          for (int i = lane; i < wd; i += kWarp) f.st(p, i, src[i]);
        }
      }
      if (kGmem) __threadfence_block();
      __syncwarp();
    }
    decode_rows(rows, tile, rows_at, N, C, lane);
    __syncwarp();
  };
  load(0, true);

  if constexpr (!kGmem) {
    if (a.table) {
      // the walk table: every node's entry, then NILSTATE and STOP
      for (int j = lane; j < N + 2; j += kWarp) {
        if (j < N) {
          const int nc = f.ld(kNodeCont, j);
          set_walk(f, j, nc, f.ld(kContParent, rd(nc, C)));
        } else {
          smem[f.walk + 2 * j] = (int)walk_entry(f, N + 1);
          smem[f.walk + 2 * j + 1] = 0;
        }
      }
      __syncwarp();
    }
  }

  // Lane 0 folds; the next row is read while the current one applies.
  bool overflow = a.in_overflow[d] != 0;
  for (int t0 = 0; t0 < T; t0 += tile) {
    if (t0 > 0) load(t0, false);
    if (lane == 0) {
      const int rows = min(tile, T - t0);
      Row r = row_at(rows_at, 0);
      for (int t = 0; t < rows; ++t) {
        const Row next = row_at(rows_at, t + 1);
        overflow |= apply_edit(f, r);
        r = next;
      }
    }
    if (kGmem) __threadfence_block();
    __syncwarp();
  }
  overflow = __shfl_sync(kFull, (int)overflow, 0) != 0;

  if constexpr (!kGmem) {
    if (bulk) {
      // each of the first lanes sends one plane back
      fence_async_shared();
      __syncwarp();
      if (lane < kPlanes) {
        const int wd = container_axis(lane) ? C : N;
        bulk_store(a.out[lane] + (size_t)d * wd,
                   smem + forest + plane_offset(lane, N, C),
                   (uint32_t)wd * 4);
      }
    } else {
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        const int wd = container_axis(p) ? C : N;
        int* dst = a.out[p] + (size_t)d * wd;
        for (int i = lane; i < wd; i += kWarp) dst[i] = f.ld(p, i);
      }
    }
  }
  if (lane == 0) a.out_overflow[d] = overflow;
  if (kDigest) write_digest(f, a, d, lane, overflow);
  if (bulk && lane < kPlanes) bulk_store_wait();
}

// Allow the block's dynamic shared memory; a size the card refuses
// returns its error and leaves no error pending for the next launch.
template <bool kGmem, bool kDigest>
cudaError_t set_smem(size_t smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      tree_fold_kernel<kGmem, kDigest>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// One block of one warp a document.
template <bool kGmem, bool kDigest>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes =
      doc_words(a.N, a.C, kGmem, a.tile, a.table) * sizeof(int);
  const cudaError_t err = set_smem<kGmem, kDigest>(bytes);
  if (err != cudaSuccess) return err;
  tree_fold_kernel<kGmem, kDigest><<<a.D, kWarp, bytes, stream>>>(a);
  return cudaGetLastError();
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// ptrs: the 9 int32 input planes and the bool overflow (TreeState order),
// the 8 edit planes (TreeEdits order), the 9 output planes and the output
// overflow, n_nodes, n_cont, digest (null without the digest): 31.
// gmem: fold in the output planes (device memory) instead of shared
// memory; docs_per_block: warps a block, which this source takes only as
// 1 (the argument keeps the entry's signature, so one binding drives this
// source and the earlier design at commit 889c28c).
int tree_fold(void* const* ptrs, int D, int N, int C, int T, int gmem,
              int docs_per_block, void* stream) {
  Args a;
  int k = 0;
  bool al = true;
  for (int p = 0; p < kPlanes; ++p) {
    a.in[p] = (const int*)ptrs[k++];
    al = al && aligned(a.in[p]);
  }
  a.in_overflow = (const uint8_t*)ptrs[k++];
  for (int p = 0; p < kEditPlanes; ++p) {
    a.edits[p] = (const int*)ptrs[k++];
    al = al && aligned(a.edits[p]);
  }
  for (int p = 0; p < kPlanes; ++p) {
    a.out[p] = (int*)ptrs[k++];
    al = al && aligned(a.out[p]);
  }
  a.out_overflow = (uint8_t*)ptrs[k++];
  a.n_nodes = (const int*)ptrs[k++];
  a.n_cont = (const int*)ptrs[k++];
  a.digest = (int*)ptrs[k++];
  a.D = D;
  a.N = N;
  a.C = C;
  a.T = T;
  a.bulk = al && N % 4 == 0 && C % 4 == 0 && T % 4 == 0;
  if (docs_per_block != 1 || D < 0 || N < 1 || C < 1 || T < 0)
    return (int)cudaErrorInvalidValue;
  a.tile = kTile;
  a.table = false;
  if (!gmem) {
    smem_layout(N, C, &a.tile, &a.table);
    if (a.tile == 0) return (int)cudaErrorInvalidValue;
  }
  if (D == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool digest = a.digest != nullptr;
  cudaError_t err;
  if (gmem)
    err = digest ? launch<true, true>(a, s) : launch<true, false>(a, s);
  else
    err = digest ? launch<false, true>(a, s) : launch<false, false>(a, s);
  return (int)err;
}

}  // extern "C"
