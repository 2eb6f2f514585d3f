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
// CPU path and the card's yardstick.
//
// resident_splice_rows: for every plane p of one namedtuple, in place,
//   out_p[d, start[d] + j, k] = rows_p[d, j, k]   for j < count[d]
// ([D, T] planes have K = 1; `pvals` is [D, T, K]).  Elements are 1, 2 or
// 4 bytes (int8 / bool, int16, int32).  Pad rows (j >= count[d]) and rows
// past T are never written.  Precondition (the caller's bucketed gather
// guarantees it): 0 <= count[d] <= L.
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
// What bounds it on this card: bytes.  Each element is read once and
// written once, with a compare or an add between; at the pinned workload
// a chunk's splice moves ~0.3 MB and a migration ~2 MB, well under the
// 50 MB L2.  So the design is the plainest that moves the bytes once:
// one thread an element, a grid-stride loop, and every plane of the tuple
// in ONE launch (blockIdx.y is the plane) from a descriptor table passed
// in the kernel's parameter space, so a tuple costs one launch and no
// descriptor copy, against ~30 small launches and a second copy of every
// plane for a gather + where + copy per plane in plain PyTorch.
//
// A launch runs on the stream it is given (the caller's current stream,
// the one the folds that read these buffers run on) and does not
// synchronise; each entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxPlanes = 16;
constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 2048;
constexpr int kInsert = 1;         // mergetree_kernel.K_INSERT
constexpr int kI16Sentinel = 32767;  // mergetree_kernel.I16_NOT_REMOVED

struct SpliceArgs {
  void* dst[kMaxPlanes];
  const void* src[kMaxPlanes];
  int esize[kMaxPlanes];  // bytes an element: 1, 2 or 4
  int inner[kMaxPlanes];  // trailing width K (1 for [D, T] planes)
  const int* start;
  const int* count;
  int D, T, L;
};

struct WidenArgs {
  const void* src[kMaxPlanes];
  int* dst[kMaxPlanes];
  int esize[kMaxPlanes];
  int mode[kMaxPlanes];
  long long numel[kMaxPlanes];
  const void* kind;  // mode 1: the op kind plane [D, W]
  int kind_esize;
  const void* n;     // mode 2: the live slot count [D]
  int n_esize;
  const int* doc_base;
  int width;         // W: T for ops, S for state
};

__device__ __forceinline__ int load_int(const void* p, int esize,
                                        long long i) {
  if (esize == 1) return static_cast<const int8_t*>(p)[i];
  if (esize == 2) return static_cast<const int16_t*>(p)[i];
  return static_cast<const int32_t*>(p)[i];
}

__global__ void splice_rows_kernel(SpliceArgs a) {
  const int p = blockIdx.y;
  const int K = a.inner[p];
  const int es = a.esize[p];
  const long long total = static_cast<long long>(a.D) * a.L * K;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int k = static_cast<int>(i % K);
    const long long r = i / K;  // d * L + j
    const int j = static_cast<int>(r % a.L);
    const int d = static_cast<int>(r / a.L);
    if (j >= __ldg(a.count + d)) continue;
    const int t = __ldg(a.start + d) + j;
    if (t < 0 || t >= a.T) continue;
    const long long di = (static_cast<long long>(d) * a.T + t) * K + k;
    if (es == 1) {
      static_cast<int8_t*>(a.dst[p])[di] =
          static_cast<const int8_t*>(a.src[p])[i];
    } else if (es == 2) {
      static_cast<int16_t*>(a.dst[p])[di] =
          static_cast<const int16_t*>(a.src[p])[i];
    } else {
      static_cast<int32_t*>(a.dst[p])[di] =
          static_cast<const int32_t*>(a.src[p])[i];
    }
  }
}

__global__ void widen_kernel(WidenArgs a) {
  const int p = blockIdx.y;
  const long long total = a.numel[p];
  const int mode = a.mode[p];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    int v = load_int(a.src[p], a.esize[p], i);
    if (mode == 1 || mode == 2) {
      const int d = static_cast<int>(i / a.width);
      const bool keep =
          mode == 1 ? load_int(a.kind, a.kind_esize, i) == kInsert
                    : static_cast<int>(i % a.width) <
                          load_int(a.n, a.n_esize, d);
      // Wrap-around addition, as torch's int32 add.
      v = keep ? static_cast<int>(static_cast<unsigned>(v) +
                                  static_cast<unsigned>(a.doc_base[d]))
               : 0;
    } else if (mode == 3 && v == kI16Sentinel) {
      v = INT_MAX;
    }
    a.dst[p][i] = v;
  }
}

dim3 grid_for(long long most, int planes) {
  long long blocks = (most + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocksX) blocks = kMaxBlocksX;
  return dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(planes));
}

}  // namespace

extern "C" int resident_splice_rows(void* const* dst, const void* const* src,
                                    const int* esize, const int* inner,
                                    int n_planes, const void* start,
                                    const void* count, int D, int T, int L,
                                    void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes) return cudaErrorInvalidValue;
  SpliceArgs a = {};
  long long most = 0;
  for (int p = 0; p < n_planes; ++p) {
    if (esize[p] != 1 && esize[p] != 2 && esize[p] != 4)
      return cudaErrorInvalidValue;
    a.dst[p] = dst[p];
    a.src[p] = src[p];
    a.esize[p] = esize[p];
    a.inner[p] = inner[p];
    const long long total = static_cast<long long>(D) * L * inner[p];
    if (total > most) most = total;
  }
  a.start = static_cast<const int*>(start);
  a.count = static_cast<const int*>(count);
  a.D = D;
  a.T = T;
  a.L = L;
  splice_rows_kernel<<<grid_for(most, n_planes), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int resident_widen(const void* const* src, void* const* dst,
                              const int* esize, const int* mode,
                              const long long* numel, int n_planes,
                              const void* kind, int kind_esize, const void* n,
                              int n_esize, const void* doc_base, int width,
                              void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || width < 1)
    return cudaErrorInvalidValue;
  WidenArgs a = {};
  long long most = 0;
  for (int p = 0; p < n_planes; ++p) {
    if (esize[p] != 1 && esize[p] != 2 && esize[p] != 4)
      return cudaErrorInvalidValue;
    if ((mode[p] == 1 && kind == nullptr) || (mode[p] == 2 && n == nullptr))
      return cudaErrorInvalidValue;
    a.src[p] = src[p];
    a.dst[p] = static_cast<int*>(dst[p]);
    a.esize[p] = esize[p];
    a.mode[p] = mode[p];
    a.numel[p] = numel[p];
    if (numel[p] > most) most = numel[p];
  }
  a.kind = kind;
  a.kind_esize = kind_esize;
  a.n = n;
  a.n_esize = n_esize;
  a.doc_base = static_cast<const int*>(doc_base);
  a.width = width;
  widen_kernel<<<grid_for(most, n_planes), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
