// The resident-buffer kernels of the catch-up cache's device tier (tier
// 2.5) for Hopper (sm_90a): the in-place suffix splice and the
// narrow-to-wide migration of resident planes.
//
// Replaces the reference's XLA-traced device code K6,
// fluidframework_tpu/ops/device_cache.py: `_splice_jit` (:126, a donated
// masked take-along-axis over every plane of a namedtuple) and
// `_widen_resident_ops` / `_widen_resident_state` (:229 / :242, the
// reference's `_widen_ops` / `_widen_state` under `jit`).  The wrapper
// is ops/resident_cuda.py; the plain PyTorch versions beside it are the
// CPU path and the card's yardstick.  The earlier design (one thread an
// element) is kept as csrc/resident_earlier.cu.
//
// resident_splice_rows / resident_splice_groups: for every plane p of one
// or more row groups g (a namedtuple each, with its own start, count, T
// and L), in place,
//   out_p[d, start_g[d] + j, k] = rows_p[d, j, k]   for j < count_g[d]
// ([D, T] planes have K = 1; `pvals` is [D, T, K]).  Elements are 1, 2 or
// 4 bytes (int8 / bool, int16, int32).  Pad rows (j >= count[d]) and rows
// outside [0, T) are never written.  Precondition (the caller's bucketed
// gather guarantees it): 0 <= count[d] <= L.
//
// resident_widen: new int32 planes from the int16/int8 upload encoding,
// bit for bit the decode of mergetree_kernel._widen_ops / _widen_state:
//   mode 0  a cast (sign-extended);
//   mode 1  op tstart: tstart + doc_base[d] on insert rows, else 0;
//   mode 2  state tstart: tstart + doc_base[d] on live slots (s < n[d]),
//           else 0;
//   mode 3  a sequence plane with the int16 sentinel 32767 mapped back to
//           NOT_REMOVED (INT32_MAX).
// The encoding rule itself (which dtypes are narrow, what is refused)
// stays in mergetree_kernel.upload_encoding, which the wrapper calls.
//
// What bounds them on this card: bytes, and at a warm chunk's size (a
// splice moves ~0.2 MB, a migration ~5 MB) the launch itself.  The earlier
// design ran one thread an element over D x L x K elements, pad rows and
// untouched documents included, each with 64-bit divides and a scalar
// copy; measured by tools/torch_kernel_turns.py on an H100 (700 W), 87% of
// its splice threads wrote nothing and 84% of the widen's cycles were the
// rebase test's divide and loads.  This design:
//   - splice: one lane a (document, plane), 32 documents a warp.  A
//     document's rows of a plane are one contiguous byte range in both
//     source and destination (count x K elements from start x K), so the
//     lane reads start and count once (coalesced across the warp), does
//     nothing when count is 0, and copies the range with the widest vector
//     (16, 8, 4 or 2 bytes) the two addresses' mutual alignment allows,
//     four loads in flight, bytes at the edges; 32-bit index math inside.
//     One launch takes up to kMaxGroups row groups (the tree's edit, node
//     and container axes), kMaxPlanes planes in all, from a descriptor
//     table in the kernel's parameter space;
//   - widen: one warp a plane's row of a document (four rows a warp were
//     slower on the card, PERF.md), 4-element vector loads
//     (char4 / short4 / int4) and int4 stores when the plane allows them
//     (a width that is a multiple of 4, aligned planes), else scalar;
//     doc_base[d] and n[d] read once a row; no divide.
//
// A launch runs on the stream it is given (the caller's current stream,
// the one the folds that read these buffers run on) and does not
// synchronise; each entry returns cudaGetLastError().  Built with
// -DRESIDENT_CYCLES, every thread counts its cycles, the cycles of its
// copies (splice) or vector loop (widen), and the elements it read and
// wrote (resident_cycles reads and resets them).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxPlanes = 32;
constexpr int kMaxGroups = 4;
constexpr int kWarps = 4;            // warps a splice block
constexpr int kWidenWarps = 8;       // warps (document rows) a widen block
constexpr int kInsert = 1;           // mergetree_kernel.K_INSERT
constexpr int kI16Sentinel = 32767;  // mergetree_kernel.I16_NOT_REMOVED
constexpr unsigned kFull = 0xffffffffu;

struct SpliceArgs {
  void* dst[kMaxPlanes];
  const void* src[kMaxPlanes];
  int esize[kMaxPlanes];  // bytes an element: 1, 2 or 4
  int inner[kMaxPlanes];  // trailing width K (1 for [D, T] planes)
  int group[kMaxPlanes];  // the plane's row group
  const int* start[kMaxGroups];
  const int* count[kMaxGroups];
  int T[kMaxGroups], L[kMaxGroups];
  int D;
};

struct WidenArgs {
  const void* src[kMaxPlanes];
  int* dst[kMaxPlanes];
  int esize[kMaxPlanes];
  int mode[kMaxPlanes];
  int width[kMaxPlanes];  // elements a document's row of the plane
  const void* kind;  // mode 1: the op kind plane [D, W]
  int kind_esize;
  const void* n;     // mode 2: the live slot count [D]
  int n_esize;
  const int* doc_base;
  int D;
};

#ifdef RESIDENT_CYCLES
__device__ unsigned long long g_cyc[6];
#define RC_DECL                      \
  const long long k0_ = clock64();  \
  long long part_ = 0, vis_ = 0, wr_ = 0
#define RC_BEGIN(v) const long long v = clock64()
#define RC_END(v) part_ += clock64() - (v)
#define RC_COUNT(nv, nw) (vis_ += (nv), wr_ += (nw))
#define RC_FLUSH flush_cycles(k0_, part_, vis_, wr_)

// Warp sums of the lanes' counters (and the slowest lane), lane 0 adds
// them; every lane of the warp calls it.
__device__ void flush_cycles(long long k0, long long part, long long vis,
                             long long wr) {
  unsigned long long v[4] = {(unsigned long long)(clock64() - k0),
                             (unsigned long long)part,
                             (unsigned long long)vis,
                             (unsigned long long)wr};
  unsigned long long mx = v[0];
  for (int o = 16; o > 0; o >>= 1) {
    for (int i = 0; i < 4; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
    const unsigned long long y = __shfl_xor_sync(kFull, mx, o);
    mx = y > mx ? y : mx;
  }
  if ((threadIdx.x & 31) == 0) {
    for (int i = 0; i < 4; ++i) atomicAdd(&g_cyc[i], v[i]);
    atomicMax(&g_cyc[4], mx);
    atomicAdd(&g_cyc[5], 32ull);
  }
}
#else
#define RC_DECL (void)0
#define RC_BEGIN(v) (void)0
#define RC_END(v) (void)0
#define RC_COUNT(nv, nw) ((void)(nv), (void)(nw))
#define RC_FLUSH (void)0
#endif

// Copy n vectors of type V from s to t, kUnroll loads in flight before
// their stores.
template <typename V>
__device__ __forceinline__ void copy_run(uint8_t* t, const uint8_t* s,
                                         int n) {
  constexpr int kUnroll = 4;
  V* tv = reinterpret_cast<V*>(t);
  const V* sv = reinterpret_cast<const V*>(s);
  for (int i = 0; i < n; i += kUnroll) {
    V r[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (i + k < n) r[k] = sv[i + k];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (i + k < n) tv[i + k] = r[k];
  }
}

// A warp takes 32 documents of one plane, a lane each: the lane reads its
// document's start and count (coalesced across the warp) and copies the
// document's contiguous byte range itself, with the widest vector the two
// addresses' mutual alignment allows and bytes at the edges, so every
// lane's loads are in flight at once.  Lanes with nothing to copy (count
// 0, or every row outside [0, T)) do nothing.
__global__ void __launch_bounds__(kWarps * 32)
splice_rows_kernel(SpliceArgs a) {
  RC_DECL;
  const int d = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32
      + (threadIdx.x & 31);
  const int p = blockIdx.y;
  const int g = a.group[p];
  if (d < a.D) {
    const int start = __ldg(a.start[g] + d);
    const int count = __ldg(a.count[g] + d);
    const int first = start < 0 ? -start : 0;  // rows before 0: not written
    const int rows = min(count, a.T[g] - start) - first;
    if (rows > 0) {
      const int es = a.esize[p] * a.inner[p];  // bytes a row
      const uint8_t* s = static_cast<const uint8_t*>(a.src[p])
          + ((size_t)d * a.L[g] + first) * es;
      uint8_t* t = static_cast<uint8_t*>(a.dst[p])
          + ((size_t)d * a.T[g] + start + first) * es;
      const int nb = rows * es;
      RC_BEGIN(c_);
      const unsigned mis = (unsigned)((uintptr_t)s ^ (uintptr_t)t);
      const int w = (mis & 15) == 0 ? 16 : (mis & 7) == 0 ? 8
          : (mis & 3) == 0 ? 4 : (mis & 1) == 0 ? 2 : 1;
      const int head = min((int)((w - ((uintptr_t)t & (w - 1))) & (w - 1)),
                           nb);
      for (int i = 0; i < head; ++i) t[i] = s[i];
      const int body = (nb - head) / w;
      if (w == 16)
        copy_run<uint4>(t + head, s + head, body);
      else if (w == 8)
        copy_run<uint2>(t + head, s + head, body);
      else if (w == 4)
        copy_run<uint32_t>(t + head, s + head, body);
      else if (w == 2)
        copy_run<uint16_t>(t + head, s + head, body);
      else
        copy_run<uint8_t>(t + head, s + head, body);
      for (int i = head + body * w; i < nb; ++i) t[i] = s[i];
      RC_END(c_);
      RC_COUNT(nb / a.esize[p], nb / a.esize[p]);
    }
  }
  RC_FLUSH;
}

__device__ __forceinline__ int load_int(const void* p, int esize, size_t i) {
  if (esize == 1) return static_cast<const int8_t*>(p)[i];
  if (esize == 2) return static_cast<const int16_t*>(p)[i];
  return static_cast<const int32_t*>(p)[i];
}

// Elements i .. i + 3 (i a multiple of 4, the row 4-element aligned).
__device__ __forceinline__ int4 load4(const void* p, int esize, size_t i) {
  if (esize == 1) {
    const char4 c = reinterpret_cast<const char4*>(p)[i / 4];
    return make_int4(c.x, c.y, c.z, c.w);
  }
  if (esize == 2) {
    const short4 c = reinterpret_cast<const short4*>(p)[i / 4];
    return make_int4(c.x, c.y, c.z, c.w);
  }
  return reinterpret_cast<const int4*>(p)[i / 4];
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// One element's decode; keep says whether a tstart is rebased.
__device__ __forceinline__ int decode(int v, int mode, bool keep, int base) {
  if (mode == 1 || mode == 2)
    // Wrap-around addition, as torch's int32 add.
    return keep ? (int)((unsigned)v + (unsigned)base) : 0;
  if (mode == 3 && v == kI16Sentinel) return INT_MAX;
  return v;
}

// One warp widens a document's row of plane p: 4-element vectors when the
// plane allows them (kVec), else one element a lane.  Returns the elements
// this lane wrote.
template <bool kVec>
__device__ __forceinline__ int widen_row(const WidenArgs& a, int p, int d,
                                         int lane) {
  const int W = a.width[p], mode = a.mode[p], es = a.esize[p];
  const size_t row = (size_t)d * W;
  const int base = mode == 1 || mode == 2 ? __ldg(a.doc_base + d) : 0;
  const int live = mode == 2 ? load_int(a.n, a.n_esize, d) : 0;
  int* dst = a.dst[p] + row;
  int done = 0;
  if (kVec) {
    for (int i = 4 * lane; i < W; i += 128) {
      const int4 v = load4(a.src[p], es, row + i);
      bool k0 = i < live, k1 = i + 1 < live, k2 = i + 2 < live,
           k3 = i + 3 < live;
      if (mode == 1) {
        const int4 kd = load4(a.kind, a.kind_esize, row + i);
        k0 = kd.x == kInsert;
        k1 = kd.y == kInsert;
        k2 = kd.z == kInsert;
        k3 = kd.w == kInsert;
      }
      reinterpret_cast<int4*>(dst)[i / 4] = make_int4(
          decode(v.x, mode, k0, base), decode(v.y, mode, k1, base),
          decode(v.z, mode, k2, base), decode(v.w, mode, k3, base));
      done += 4;
    }
  } else {
    for (int i = lane; i < W; i += 32) {
      const bool keep = mode == 1
          ? load_int(a.kind, a.kind_esize, row + i) == kInsert
          : i < live;
      dst[i] = decode(load_int(a.src[p], es, row + i), mode, keep, base);
      done += 1;
    }
  }
  return done;
}

__global__ void __launch_bounds__(kWidenWarps * 32)
widen_kernel(WidenArgs a) {
  RC_DECL;
  const int d = blockIdx.x * kWidenWarps + (threadIdx.x >> 5);
  const int p = blockIdx.y;
  int done = 0;
  if (d < a.D) {
    RC_BEGIN(c_);
    // Vectors when every row of the plane allows them: a width that is a
    // multiple of 4 and 4-element aligned planes.
    const bool vec = a.width[p] % 4 == 0
        && aligned(a.src[p], 4 * a.esize[p]) && aligned(a.dst[p], 16)
        && (a.mode[p] != 1 || aligned(a.kind, 4 * a.kind_esize));
    done = vec ? widen_row<true>(a, p, d, threadIdx.x & 31)
               : widen_row<false>(a, p, d, threadIdx.x & 31);
    RC_END(c_);
  }
  RC_COUNT(done, done);
  RC_FLUSH;
}

// Blocks of `warps` warps, each warp taking `per_warp` documents of a plane.
dim3 grid_for(int D, int planes, int warps, int per_warp) {
  const int per_block = warps * per_warp;
  return dim3(static_cast<unsigned>((D + per_block - 1) / per_block),
              static_cast<unsigned>(planes));
}

bool valid_esize(int e) { return e == 1 || e == 2 || e == 4; }

}  // namespace

extern "C" {

#ifdef RESIDENT_CYCLES
// Per-thread counters since the last call, summed: cycles, cycles of the
// copies (splice) or vector loop (widen), elements read, elements written;
// then the slowest thread's cycles and the threads.  Reads and resets them.
int resident_cycles(unsigned long long* out) {
  const cudaError_t e = cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[6] = {};
  return (int)cudaMemcpyToSymbol(g_cyc, zero, sizeof(g_cyc));
}
#endif

// The splice of n_groups row groups in one launch: plane p belongs to
// group[p]; group g has start[g] / count[g] ([D] int32 each on the card),
// T[g] rows a resident plane and L[g] a rows plane.
int resident_splice_groups(void* const* dst, const void* const* src,
                           const int* esize, const int* inner,
                           const int* group, int n_planes,
                           const void* const* start,
                           const void* const* count, const int* T,
                           const int* L, int n_groups, int D, void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || n_groups < 1
      || n_groups > kMaxGroups || D < 0)
    return cudaErrorInvalidValue;
  SpliceArgs a = {};
  for (int g = 0; g < n_groups; ++g) {
    a.start[g] = static_cast<const int*>(start[g]);
    a.count[g] = static_cast<const int*>(count[g]);
    a.T[g] = T[g];
    a.L[g] = L[g];
  }
  for (int p = 0; p < n_planes; ++p) {
    if (!valid_esize(esize[p]) || inner[p] < 1 || group[p] < 0
        || group[p] >= n_groups)
      return cudaErrorInvalidValue;
    a.dst[p] = dst[p];
    a.src[p] = src[p];
    a.esize[p] = esize[p];
    a.inner[p] = inner[p];
    a.group[p] = group[p];
  }
  a.D = D;
  if (D == 0) return 0;
  splice_rows_kernel<<<grid_for(D, n_planes, kWarps, 32), kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One row group (the earlier design's entry, kept for its callers).
int resident_splice_rows(void* const* dst, const void* const* src,
                         const int* esize, const int* inner, int n_planes,
                         const void* start, const void* count, int D, int T,
                         int L, void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes) return cudaErrorInvalidValue;
  int group[kMaxPlanes] = {};
  return resident_splice_groups(dst, src, esize, inner, group, n_planes,
                                &start, &count, &T, &L, 1, D, stream);
}

// The migration: plane p is src[p] (esize[p] bytes an element, numel[p]
// elements, decode mode[p]) into the int32 dst[p]; plane 0 is [D, width].
int resident_widen(const void* const* src, void* const* dst,
                   const int* esize, const int* mode, const long long* numel,
                   int n_planes, const void* kind, int kind_esize,
                   const void* n, int n_esize, const void* doc_base,
                   int width, void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || doc_base == nullptr)
    return cudaErrorInvalidValue;
  WidenArgs a = {};
  for (int p = 0; p < n_planes; ++p) {
    if (!valid_esize(esize[p]) || mode[p] < 0 || mode[p] > 3)
      return cudaErrorInvalidValue;
    if ((mode[p] == 1 && kind == nullptr) || (mode[p] == 2 && n == nullptr))
      return cudaErrorInvalidValue;
  }
  // Plane 0 is [D, width]; every plane has D rows of numel / D elements.
  if (width < 1 || numel[0] % width) return cudaErrorInvalidValue;
  const int D = static_cast<int>(numel[0] / width);
  for (int p = 0; p < n_planes; ++p) {
    if (D == 0 ? numel[p] != 0 : numel[p] % D) return cudaErrorInvalidValue;
    a.src[p] = src[p];
    a.dst[p] = static_cast<int*>(dst[p]);
    a.esize[p] = esize[p];
    a.mode[p] = mode[p];
    a.width[p] = D == 0 ? 0 : static_cast<int>(numel[p] / D);
  }
  a.kind = kind;
  a.kind_esize = kind_esize;
  a.n = n;
  a.n_esize = n_esize;
  a.doc_base = static_cast<const int*>(doc_base);
  a.D = D;
  if (D == 0) return 0;
  widen_kernel<<<grid_for(D, n_planes, kWidenWarps, 1), kWidenWarps * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
