// The earlier design of csrc/map_lww.cu, the SharedMap LWW reduction (K7),
// kept unchanged below this note as the yardstick the current kernel is
// timed against: chip_smoke.py builds it beside the kernels and reports its
// time on the same inputs as `earlier_ms`, and tools/torch_kernel_turns.py
// times the two in turns.  No entry point of the port launches it;
// ops/map_lww_cuda.earlier_library() binds it for those measurements, which
// hold its results equal to the current kernel's, bit for bit.
//
// SharedMap last-writer-wins reduction for Hopper (sm_90a).
//
// Replaces the reference's XLA-traced device code K7,
// fluidframework_tpu/ops/map_kernel.py:_map_lww_kernel (:140): three
// jax.ops.segment_max reductions over the flat batch of every document's
// set / delete rows and clear rows, then one per-key test:
//
//   max_seq[g]    = max op_seq over the rows of key g
//   last_clear[d] = max clear_seq over the clears of document d
//   win_set[g]    = max over the rows of key g of
//                   (op_seq == max_seq[key_gid] ? is_set : -1)
//   win_val[g]    = the same with val_idx
//   present[g]    = win_set[g] == 1 && max_seq[g] > last_clear[key_doc[g]]
//
// segment_max's rules hold exactly: an empty segment stays INT32_MIN (a
// document with no clear keeps its base keys, which enter at seq 0), and
// a row whose segment id lies outside [0, segments) is dropped.  The one
// gather, last_clear[key_doc[g]], follows XLA's rule (a negative index
// counts from the end, then the index is clamped).  The wrapper and its
// plain PyTorch version are ops/map_lww_cuda.py and
// ops/map_kernel.map_lww_reference.
//
// Design.  Four launches on the caller's stream, behind one C entry:
//   1. init:    the four reduction targets (max_seq, win_set, win_val
//               [G] and last_clear [docs]) to INT32_MIN, which cudaMemset
//               cannot write;
//   2. seqs:    a grid-stride pass over the N op rows (atomicMax into
//               max_seq) and the M clear rows (into last_clear);
//   3. winners: a grid-stride pass over the op rows; a winner row
//               (op_seq == max_seq[g], after pass 2 has finished) does
//               atomicMax into win_set and win_val, every other row
//               contributes -1, with an atomic only while the word still
//               reads below -1;
//   4. present: one thread a key.
// Max is order-free, so the result is deterministic whatever order the
// atomics land in.  The wrapper allocates the outputs and the scratch.
//
// What bounds it on this card: bytes.  Each input is read once (pass 3
// re-reads key_gid and op_seq, and max_seq from L2) and each output is
// written once: at N = 1,048,576 op rows, G = 262,144 keys and M = 32,768
// clears (10,240 documents of the map workload) that is 19.4 MB, 5.8 us
// at 3.35 TB/s; the work is a compare and an atomic a row.  Measured by
// chip_smoke.py on an H100 (700 W) at that shape: 0.163 ms, 28x the
// bound, against 0.426 ms for the same reduction as a chain of torch
// scatter_reduce_ calls.  What holds it back is not measured (no profiler
// counters); the likely cost is the atomics on the hot keys of each
// document (rows of one key in one warp serialise on one word) and the
// four dependent launches.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct LwwArgs {
  const int32_t* key_gid;    // [N]
  const int32_t* op_seq;     // [N]
  const int32_t* is_set;     // [N]
  const int32_t* val_idx;    // [N]
  const int32_t* key_doc;    // [G]
  const int32_t* clear_doc;  // [M]
  const int32_t* clear_seq;  // [M]
  int32_t* max_seq;          // [G] scratch
  int32_t* win_set;          // [G] scratch
  int32_t* last_clear;       // [docs] scratch
  int32_t* win_val;          // [G] out
  uint8_t* present;          // [G] out (torch.bool)
  int N, G, M, docs;
};

__global__ void init_kernel(LwwArgs a) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.G; i += stride) {
    a.max_seq[i] = INT_MIN;
    a.win_set[i] = INT_MIN;
    a.win_val[i] = INT_MIN;
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.docs; i += stride)
    a.last_clear[i] = INT_MIN;
}

__global__ void seq_kernel(LwwArgs a) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.N; i += stride) {
    const int g = a.key_gid[i];
    if (g >= 0 && g < a.G) atomicMax(&a.max_seq[g], a.op_seq[i]);
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.M; i += stride) {
    const int d = a.clear_doc[i];
    if (d >= 0 && d < a.docs) atomicMax(&a.last_clear[d], a.clear_seq[i]);
  }
}

__global__ void winner_kernel(LwwArgs a) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.N; i += stride) {
    const int g = a.key_gid[i];
    if (g < 0 || g >= a.G) continue;  // dropped by segment_max
    if (a.op_seq[i] != a.max_seq[g]) {
      // A loser contributes -1.  The max only grows, so once a word
      // reads -1 or more the loser cannot change it and skips the atomic
      // (a stale read only costs an atomic that changes nothing).
      if (a.win_set[g] < -1) atomicMax(&a.win_set[g], -1);
      if (a.win_val[g] < -1) atomicMax(&a.win_val[g], -1);
      continue;
    }
    atomicMax(&a.win_set[g], a.is_set[i]);
    atomicMax(&a.win_val[g], a.val_idx[i]);
  }
}

__global__ void present_kernel(LwwArgs a) {
  const int stride = gridDim.x * blockDim.x;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < a.G; g += stride) {
    int d = a.key_doc[g];
    if (d < 0) d += a.docs;
    d = min(max(d, 0), a.docs - 1);
    a.present[g] = a.win_set[g] == 1 && a.max_seq[g] > a.last_clear[d];
  }
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

extern "C" {

// ptrs: key_gid, op_seq, is_set, val_idx [N]; key_doc [G]; clear_doc,
// clear_seq [M]; the scratch max_seq, win_set [G] and last_clear [docs];
// the outputs win_val [G] (int32) and present [G] (bool).  G >= 1 and
// docs >= 1.  Returns cudaGetLastError() after the last launch (0 =
// launched); a launch that is refused stops the sequence there.
int map_lww(void* const* ptrs, int N, int G, int M, int docs, void* stream) {
  if (G < 1 || docs < 1 || N < 0 || M < 0) return (int)cudaErrorInvalidValue;
  LwwArgs a;
  a.key_gid = (const int32_t*)ptrs[0];
  a.op_seq = (const int32_t*)ptrs[1];
  a.is_set = (const int32_t*)ptrs[2];
  a.val_idx = (const int32_t*)ptrs[3];
  a.key_doc = (const int32_t*)ptrs[4];
  a.clear_doc = (const int32_t*)ptrs[5];
  a.clear_seq = (const int32_t*)ptrs[6];
  a.max_seq = (int32_t*)ptrs[7];
  a.win_set = (int32_t*)ptrs[8];
  a.last_clear = (int32_t*)ptrs[9];
  a.win_val = (int32_t*)ptrs[10];
  a.present = (uint8_t*)ptrs[11];
  a.N = N;
  a.G = G;
  a.M = M;
  a.docs = docs;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = N > M ? N : M;
  const long long targets = G > docs ? G : docs;
  init_kernel<<<blocks_for(targets), kThreads, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  seq_kernel<<<blocks_for(rows), kThreads, 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  winner_kernel<<<blocks_for(N), kThreads, 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  present_kernel<<<blocks_for(G), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
