// The earlier design of csrc/tree_fold.cu, the SharedTree edit-fold (K5),
// kept unchanged below this note as the yardstick the current kernel is
// timed against: chip_smoke.py builds it beside the kernels and reports its
// time on the same inputs as `earlier_ms`, and tools/torch_kernel_turns.py
// times the two in turns.  No entry point of the port launches it;
// ops/tree_fold_cuda.earlier_library() binds it for those measurements,
// which hold its results equal to the current kernel's, bit for bit.
//
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
// the gathers before a select), so `get` / `put` below apply exactly
// those rules.  Within one edit the writes go in the reference's order,
// and where two indices alias the last write wins.
//
// What bounds it on this card: the dependent chain of each document, not
// bytes or operations.  A document's edits are a sequence of scalar
// pointer reads and writes (a move walks up to 64 ancestors, two
// dependent reads a step), so one thread folds one document, branching on
// the edit kind; the reference's compute-every-branch-then-select form
// would multiply the chain.  The design keeps that chain in shared memory:
// one warp a document, the warp copies the document's 7N + 2C int32 words
// in with coalesced loads (8 KiB at N = 256, C = 128), lane 0 folds,
// edit rows arrive 32 at a time in the lanes' registers (coalesced loads,
// handed to lane 0 by shuffles), and the warp writes the planes back and
// forms the digest with wrapping warp-shuffle sums.  Many documents run
// at once (4 warps a block, as many blocks a SM as shared memory allows),
// so the card overlaps their chains.  A document whose forest does not
// fit a block's shared memory folds in its slice of the output planes in
// device memory instead (kGmem), with the same code; nothing is refused
// for size.
//
// A launch runs on the stream it is given and does not synchronise; the
// entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kNil = -1;
constexpr int kNotRemoved = INT_MAX;
constexpr int kMaxDepth = 64;  // tree_kernel.MAX_DEPTH
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

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
};

__host__ __device__ __forceinline__ bool container_axis(int p) {
  return p == kHead || p == kContParent;
}

// int32 words of one document's forest
__host__ __device__ __forceinline__ long long doc_words(int N, int C) {
  return 7LL * N + 2LL * C;
}

// A document's working forest: one pointer a plane, each `N` or `C` wide.
struct Forest {
  int* p[kPlanes];
  int N, C;
};

// The read rule: count a negative index from the end, then clamp.
__device__ __forceinline__ int get(const int* plane, int n, int i) {
  if (i < 0) i += n;
  i = i < 0 ? 0 : (i >= n ? n - 1 : i);
  return plane[i];
}

// The write rule: count a negative index from the end; drop outside.
__device__ __forceinline__ void put(int* plane, int n, int i, int v) {
  if (i < 0) i += n;
  if (i >= 0 && i < n) plane[i] = v;
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

__device__ __forceinline__ bool expired(const Forest& f, int idx,
                                        int purge) {
  const int rs = get(f.p[kRemovedSeq], f.N, idx);
  return rs != kNotRemoved && rs <= purge;
}

// tree_kernel._splice_after: link [first..tail] into container c after
// anchor, or at the head when the anchor is NIL or not in c.
__device__ void splice_after(Forest& f, int c, int anchor, int first,
                             int tail) {
  const int N = f.N, C = f.C;
  const bool use = anchor != kNil && get(f.p[kNodeCont], N, anchor) == c;
  const int old = use ? get(f.p[kNext], N, anchor) : get(f.p[kHead], C, c);
  put(f.p[kNext], N, tail, old);
  if (old != kNil) put(f.p[kPrev], N, old, tail);
  if (use) put(f.p[kNext], N, anchor, first);
  put(f.p[kPrev], N, first, use ? anchor : kNil);
  if (!use) put(f.p[kHead], C, c, first);
}

// One edit row (tree_kernel._apply_edit); returns the row's overflow bit.
__device__ bool apply_edit(Forest& f, const int* r) {
  const int N = f.N, C = f.C;
  const int seq = r[eSeq], c = r[eContainer], first = r[eFirst];
  const int purge = r[ePurge];
  switch (r[eKind]) {
    case kInsert: {
      int anchor = r[eAnchor];
      if (anchor != kNil && expired(f, anchor, purge)) anchor = kNil;
      splice_after(f, c, anchor, first, r[eTail]);
      return false;
    }
    case kRemove:
      if (get(f.p[kRemovedSeq], N, first) == kNotRemoved)
        put(f.p[kRemovedSeq], N, first, seq);
      return false;
    case kSet:
      put(f.p[kValue], N, first, r[eValue]);
      put(f.p[kValueSeq], N, first, seq);
      return false;
    case kMove: {
      // The cycle test: walk the destination's ancestors.  A walk that
      // stops (root reached) stays stopped, so the loop ends there; one
      // still going after kMaxDepth steps overflows, hit or not.
      const int owner = get(f.p[kContParent], C, c);
      bool hit = false, alive = true;
      int cur = owner;
      for (int k = 0; k < kMaxDepth && alive; ++k) {
        hit |= cur == first;
        const int cc = cur != kNil ? get(f.p[kNodeCont], N, cur) : kNil;
        cur = cc != kNil ? get(f.p[kContParent], C, cc) : kNil;
        alive = cc != kNil;
      }
      if (!hit && !expired(f, first, purge) && !expired(f, owner, purge)) {
        int anchor = r[eAnchor];
        if (anchor == first) anchor = kNil;
        if (anchor != kNil && expired(f, anchor, purge)) anchor = kNil;
        // detach (tree_kernel._detach)
        const int p = get(f.p[kPrev], N, first);
        const int nx = get(f.p[kNext], N, first);
        const int c_old = get(f.p[kNodeCont], N, first);
        if (p == kNil) put(f.p[kHead], C, c_old, nx);
        if (p != kNil) put(f.p[kNext], N, p, nx);
        if (nx != kNil) put(f.p[kPrev], N, nx, p);
        splice_after(f, c, anchor, first, first);
        put(f.p[kNodeCont], N, first, c);
        put(f.p[kInsertSeq], N, first, seq);
      }
      return alive;
    }
    default:
      return false;
  }
}

// mergetree_kernel._mix_u32 / tree_pipeline's weights
__device__ __forceinline__ uint32_t mix_u32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

template <bool kGmem, bool kDigest>
__global__ void __launch_bounds__(128)
tree_fold_kernel(const Args a) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = threadIdx.x / kWarp;
  const int d = blockIdx.x * (blockDim.x / kWarp) + w;
  if (d >= a.D) return;  // the whole warp leaves together
  const int N = a.N, C = a.C, T = a.T;

  Forest f;
  f.N = N;
  f.C = C;
  int* base = smem + (size_t)w * doc_words(N, C);
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const int width = container_axis(p) ? C : N;
    if (kGmem) {
      f.p[p] = a.out[p] + (size_t)d * width;
    } else {
      f.p[p] = base;
      base += width;
    }
    const int* src = a.in[p] + (size_t)d * width;
    for (int i = lane; i < width; i += kWarp) f.p[p][i] = src[i];
  }
  uint8_t overflow = a.in_overflow[d];
  if (kGmem) __threadfence_block();
  __syncwarp();

  // Lane 0 folds; the edit rows come 32 at a time, one a lane.
  for (int t0 = 0; t0 < T; t0 += kWarp) {
    const int t = t0 + lane;
    int e[kEditPlanes];
#pragma unroll
    for (int k = 0; k < kEditPlanes; ++k)
      e[k] = t < T ? a.edits[k][(size_t)d * T + t] : 0;
    const int rows = T - t0 < kWarp ? T - t0 : kWarp;
    for (int j = 0; j < rows; ++j) {
      int r[kEditPlanes];
#pragma unroll
      for (int k = 0; k < kEditPlanes; ++k) r[k] = __shfl_sync(kFull, e[k], j);
      if (lane == 0 && r[eKind] != 0 && apply_edit(f, r)) overflow = 1;
    }
  }
  overflow = (uint8_t)__shfl_sync(kFull, (int)overflow, 0);
  if (kGmem) __threadfence_block();
  __syncwarp();

  if (!kGmem) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      const int width = container_axis(p) ? C : N;
      int* dst = a.out[p] + (size_t)d * width;
      for (int i = lane; i < width; i += kWarp) dst[i] = f.p[p][i];
    }
  }
  if (lane == 0) a.out_overflow[d] = overflow;

  if (kDigest) {
    const int nn = a.n_nodes[d], nc = a.n_cont[d];
    uint32_t acc0 = 0, acc1 = 0;
    for (int i = lane; i < N && i < nn; i += kWarp) {
      const uint32_t pos = (uint32_t)i * 0x01000193u;
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const uint32_t v = (uint32_t)f.p[node_digest_plane(k)][i] ^ kActiveXor;
        acc0 += v * mix_u32(pos + (uint32_t)k + kSalt0);
        acc1 += v * mix_u32(pos + (uint32_t)k + kSalt1);
      }
    }
    for (int i = lane; i < C && i < nc; i += kWarp) {
      const uint32_t pos = (uint32_t)i * 0x01000193u;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const uint32_t v = (uint32_t)f.p[cont_digest_plane(k)][i] ^ kActiveXor;
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
}

template <bool kGmem, bool kDigest>
cudaError_t launch(const Args& a, int docs_per_block, cudaStream_t stream) {
  const dim3 block(kWarp * docs_per_block);
  const dim3 grid((a.D + docs_per_block - 1) / docs_per_block);
  size_t smem = 0;
  if (!kGmem) {
    smem = (size_t)docs_per_block * doc_words(a.N, a.C) * sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          tree_fold_kernel<kGmem, kDigest>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
  }
  tree_fold_kernel<kGmem, kDigest><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: the 9 int32 input planes and the bool overflow (TreeState order),
// the 8 edit planes (TreeEdits order), the 9 output planes and the output
// overflow, n_nodes, n_cont, digest (null without the digest): 31.
// gmem: fold in the output planes (device memory) instead of shared
// memory; docs_per_block: warps a block (1..4).
int tree_fold(void* const* ptrs, int D, int N, int C, int T, int gmem,
              int docs_per_block, void* stream) {
  Args a;
  int k = 0;
  for (int p = 0; p < kPlanes; ++p) a.in[p] = (const int*)ptrs[k++];
  a.in_overflow = (const uint8_t*)ptrs[k++];
  for (int p = 0; p < kEditPlanes; ++p) a.edits[p] = (const int*)ptrs[k++];
  for (int p = 0; p < kPlanes; ++p) a.out[p] = (int*)ptrs[k++];
  a.out_overflow = (uint8_t*)ptrs[k++];
  a.n_nodes = (const int*)ptrs[k++];
  a.n_cont = (const int*)ptrs[k++];
  a.digest = (int*)ptrs[k++];
  a.D = D;
  a.N = N;
  a.C = C;
  a.T = T;
  if (docs_per_block < 1 || docs_per_block > 4) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool digest = a.digest != nullptr;
  cudaError_t err;
  if (gmem)
    err = digest ? launch<true, true>(a, docs_per_block, s)
                 : launch<true, false>(a, docs_per_block, s);
  else
    err = digest ? launch<false, true>(a, docs_per_block, s)
                 : launch<false, false>(a, docs_per_block, s);
  return (int)err;
}

}  // extern "C"
