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
// What bounds it on this card: bytes.  Each input is read once and each
// output written once: at N = 1,048,576 op rows, G = 262,144 keys and
// M = 32,768 clears (10,240 documents of the map workload) that is
// 19.4 MB, 5.8 us at 3.35 TB/s, with a compare or two a row.  An earlier
// design of this file reached 28x that bound: four dependent launches
// (an init pass, because cudaMemset cannot write INT32_MIN; the seqs; the
// winners, which read every row again to compare it with max_seq; the
// present test), each doing one global atomic a row, and the rows of one
// document's hot keys landing on the same words in one warp, where the
// atomics serialise.
//
// Design.  One pass over the rows, then one thread a key:
//   - Every reduction target is a word whose all-zero state reads as the
//     empty segment, so one cudaMemsetAsync to 0 replaces the init pass.
//     An int32 v is carried as the uint32 v ^ 0x80000000 ("biased"), which
//     orders as the int32 does and maps INT32_MIN to 0.
//   - (seq, payload) is one 64-bit word, biased seq above biased payload,
//     so its unsigned maximum is the largest seq and, among the rows with
//     that seq (the winners), the largest payload: one word for is_set,
//     one for val_idx.  The seqs pass and the winners pass become one.
//   - A loser row (seq below the key's maximum) contributes -1 to both
//     maxima.  The words alone cannot tell whether a key has a loser, and
//     the answer differs where a winner's payload is below -1, which the
//     plain version defines for any int32 input.  So the pass also keeps
//     each key's least seq (as the maximum of its complement, so that 0
//     again reads as empty), and the key pass applies max(., -1) where the
//     least seq is below the largest.
//   - Each warp reduces its 32 rows by key before touching device
//     memory: __match_any_sync groups the lanes holding one key, every
//     lane folds its group's other members into its own values by
//     shuffles (a warp-uniform loop as long as the largest group), and
//     the group's first lane issues three atomics for the whole group.  A
//     key's rows spread over many warps still land on one word, in any
//     order: the maxima and minimum are order-free, so the result is
//     deterministic.
//   - The clear rows ride in the same launch (one atomic a clear row; a
//     padding clear, seq INT32_MIN, biases to 0 and changes nothing, so
//     it is skipped).
//   - The key pass decodes the words, gathers last_clear by XLA's rule
//     and writes win_val and present.
// The packer emits rows in document order with each document's keys
// contiguous, so a warp's 32 rows hold some ten keys: about three atomics
// for every eight rows.  The answer does not depend on that order.
//
// Measured with tools/torch_kernel_turns.py on an H100 (700 W) at the
// shape above: 0.0257 ms (4.4x the bytes bound), against 0.161 ms for the
// earlier design in the same process, bit for bit equal; the memset
// 0.0062 ms (a 16-byte zeroing kernel in its place took the same: the
// launch, not the 5.3 MB, sets it), the row pass ~0.016 ms (its atomics
// ~0.002 ms: the rest is the group reductions and the reads), the key
// pass ~0.004 ms.  Reducing one key at a time with __reduce_max_sync /
// __reduce_min_sync took the row pass to ~0.026 ms: those reductions
// give one warp-wide value, so a warp looped over its keys, four of them
// a key.
//
// A launch runs on the stream it is given and does not synchronise; the
// entry returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kBias = 0x80000000u;

struct LwwArgs {
  const int32_t* key_gid;           // [N]
  const int32_t* op_seq;            // [N]
  const int32_t* is_set;            // [N]
  const int32_t* val_idx;           // [N]
  const int32_t* key_doc;           // [G]
  const int32_t* clear_doc;         // [M]
  const int32_t* clear_seq;         // [M]
  unsigned long long* set_word;     // [G] scratch: (seq, is_set) maximum
  unsigned long long* val_word;     // [G] scratch: (seq, val_idx) maximum
  uint32_t* low_word;               // [G] scratch: ~least biased seq
  uint32_t* clear_word;             // [docs] scratch: largest biased clear
  int32_t* win_val;                 // [G] out
  uint8_t* present;                 // [G] out (torch.bool)
  int N, G, M, docs;
};

__device__ __forceinline__ uint32_t biased(int v) {
  return (uint32_t)v ^ kBias;
}

__device__ __forceinline__ int unbiased(uint32_t u) {
  return (int)(u ^ kBias);
}

// One pass over the op rows (a warp takes 32 at a time) and the clears.
__global__ void __launch_bounds__(kThreads) rows_kernel(LwwArgs a) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long base = warp * 32; base < a.N; base += warps * 32) {
    const long long i = base + lane;
    int g = -1;
    uint32_t seq = 0, st = 0, vl = 0;
    bool valid = false;
    if (i < a.N) {
      g = a.key_gid[i];
      valid = g >= 0 && g < a.G;  // segment_max drops the others
      seq = biased(a.op_seq[i]);
      st = biased(a.is_set[i]);
      vl = biased(a.val_idx[i]);
    }
    // Each lane reduces its key's group: __match_any_sync gives the lanes
    // that hold the same key, and every lane walks its group's other
    // members, one a step, taking their values by shuffles; the warp runs
    // as many steps as its largest group needs (a lane whose group is
    // done reads itself again, which changes nothing).  A lane whose row
    // is dropped forms a group of its own.
    const unsigned group = __match_any_sync(kFull, valid ? g : -1 - lane);
    unsigned rest = group & ~(1u << lane);
    const int steps = __reduce_max_sync(kFull, (unsigned)__popc(rest));
    uint32_t hi = seq, lo = seq, smax = st, vmax = vl;
    for (int k = 0; k < steps; ++k) {
      const int src = rest ? __ffs(rest) - 1 : lane;
      rest &= rest - 1;
      const uint32_t m_seq = __shfl_sync(kFull, seq, src);
      const uint32_t m_st = __shfl_sync(kFull, st, src);
      const uint32_t m_vl = __shfl_sync(kFull, vl, src);
      if (m_seq > hi) {  // a later winner: its payloads replace the others
        hi = m_seq;
        smax = m_st;
        vmax = m_vl;
      } else if (m_seq == hi) {
        smax = max(smax, m_st);
        vmax = max(vmax, m_vl);
      }
      lo = min(lo, m_seq);
    }
    const bool lead = valid && lane == __ffs(group) - 1;
    if (lead) {
      const unsigned long long h = (unsigned long long)hi << 32;
      atomicMax(&a.set_word[g], h | smax);
      atomicMax(&a.val_word[g], h | vmax);
      atomicMax(&a.low_word[g], ~lo);
    }
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.M; i += stride) {
    const int d = a.clear_doc[i];
    const uint32_t s = biased(a.clear_seq[i]);
    if (d >= 0 && d < a.docs && s != 0u) atomicMax(&a.clear_word[d], s);
  }
}

// One thread a key: decode the words, apply the losers' -1, gather
// last_clear by XLA's rule, write the outputs.
__global__ void __launch_bounds__(kThreads) keys_kernel(LwwArgs a) {
  const int stride = gridDim.x * blockDim.x;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < a.G; g += stride) {
    const unsigned long long sw = a.set_word[g];
    const uint32_t top = (uint32_t)(sw >> 32);
    const uint32_t low = ~a.low_word[g];  // all ones when empty
    int win_set = unbiased((uint32_t)sw);
    int win_val = unbiased((uint32_t)a.val_word[g]);
    if (low < top) {  // a loser row: its -1 joins both maxima
      win_set = max(win_set, -1);
      win_val = max(win_val, -1);
    }
    int d = a.key_doc[g];
    if (d < 0) d += a.docs;
    d = min(max(d, 0), a.docs - 1);
    a.win_val[g] = win_val;
    a.present[g] = win_set == 1 && unbiased(top) > unbiased(a.clear_word[d]);
  }
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

extern "C" {

// ptrs: key_gid, op_seq, is_set, val_idx [N]; key_doc [G]; clear_doc,
// clear_seq [M]; the scratch: 8 G bytes, 8 G bytes and 4 (G + docs)
// bytes, each 8-byte aligned (one memset when the three are contiguous,
// in that order); the outputs win_val [G] (int32) and present [G] (bool).
// G >= 1 and docs >= 1.  Returns the first CUDA error of the memset and
// the two launches (0 = launched); a step that is refused stops the
// sequence there.
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
  a.set_word = (unsigned long long*)ptrs[7];
  a.val_word = (unsigned long long*)ptrs[8];
  a.low_word = (uint32_t*)ptrs[9];
  a.clear_word = a.low_word + G;
  a.win_val = (int32_t*)ptrs[10];
  a.present = (uint8_t*)ptrs[11];
  a.N = N;
  a.G = G;
  a.M = M;
  a.docs = docs;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t words = (size_t)G * 8;
  const size_t tail = ((size_t)G + docs) * 4;
  cudaError_t e;
  if ((char*)ptrs[8] == (char*)ptrs[7] + words &&
      (char*)ptrs[9] == (char*)ptrs[8] + words) {
    e = cudaMemsetAsync(ptrs[7], 0, 2 * words + tail, s);
  } else {
    e = cudaMemsetAsync(ptrs[7], 0, words, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(ptrs[8], 0, words, s);
    if (e == cudaSuccess) e = cudaMemsetAsync(ptrs[9], 0, tail, s);
  }
  if (e != cudaSuccess) return (int)e;
  const long long rows = N > M ? N : M;
  rows_kernel<<<blocks_for(rows), kThreads, 0, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  keys_kernel<<<blocks_for(G), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
