// SharedMatrix resolving axis fold for NVIDIA Hopper (sm_90a).
//
// Replaces the reference's XLA-traced K4,
// fluidframework_tpu/ops/matrix_kernel.py:replay_scan_resolving (:70, with
// _resolve_handle :58, jitted as _replay_matrix_batch :81): the merge-tree
// fold of each axis stream (a document's rows at 2d, its columns at 2d + 1)
// with every K_RESOLVE row's handle read on the state before it.  Bit for
// bit the semantics of mergetree_kernel._apply_op and _resolve_handle on
// the streams pack_matrix_batch makes; the wrapper is
// ops/matrix_fold_cuda.py, the plain version matrix_kernel
// .replay_scan_resolving.
//
// The matrix stream's facts are this build's own (the reference's K2 fact
// has_ob=False, where it holds by construction):
//   - rows are padding (0), insert (1), remove (2) or resolve (5) only;
//   - every pvals entry is PROP_NOT_TOUCHED (K = 1);
//   - the four obliterate planes hold their fill (NOT_REMOVED / -1) on
//     every live slot.
// The fold then never reads or writes an obliterate plane: an insert's
// arrival kill never fires, no slot expires into an obliterate test, and
// the view's obliterate terms reduce to "a removed slot is in the view of
// client -1".  The kernel counts each stream's violated facts into
// viol[d]; the wrapper's caller raises on a non-zero count, so a stream
// outside the facts never yields an answer.
//
// Design.  A team folds one stream: one warp for S <= 128 (several teams a
// block, no block barrier), else the whole block (S / 16 threads, 64 to
// 1,024).  The team's working area holds the 8 slot planes, props and the
// view's v / cum [S] each (shared memory when it fits a block, else the
// stream's slice of a device-memory scratch) and a tile of 64 op rows with
// their resolved handles.  Per row:
//   - a run of up to 4 adjacent resolves (no row between them changes the
//     state) takes one pass: each thread loads its slot once, forms the 4
//     visible lengths, and the team scans the 4 at once; the thread whose
//     slot holds position a writes the handle into the tile.  No v / cum is
//     stored, and the pass stops after the chunk whose running sum passes
//     every a (a zero-width slot at cum == a ending a chunk does not stop
//     it);
//   - an insert or remove takes one view (v / cum stored, the split slots
//     and the insert's tie-break slot found by the one thread that holds
//     each) and one move, top down in chunks of the team's width: read,
//     barrier, write each piece once at its final place, with the remove's
//     stamps.
// A cold batch (no base summary: every plane is its fill, n = 0) reads no
// state: the prologue writes the fills.  Device memory sees the op rows
// once, the state out once (and the state in once when warm) and the
// resolved handles once.
//
// Bound.  At the matrix entry's main batch (20,480 streams, S = 128,
// T = 64, cold) the bytes it must move are the op rows (9 fields read),
// the 9 state planes out and the handles: ~147 MB, ~44 us at 3.35 TB/s.
// What holds a design back is the chain of each stream's 64 dependent rows;
// its cost per row is what the resolve batching and the one-pass resolve
// cut.  Measured: see PERF.md (tools/torch_kernel_turns.py, chip_smoke.py).
//
// Built with -DMATRIX_FOLD_CYCLES, each team's thread 0 counts its cycles
// in the copy in, the resolves, the folding rows' view and move, and the
// write-back (matrix_fold_cycles reads and resets them); the counters cost
// nothing in the normal build.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <mutex>
#include <vector>

namespace {

constexpr int32_t kNotRemoved = 0x7fffffff;
constexpr int32_t kPropAbsent = -1;
constexpr int32_t kPropNotTouched = -2;
constexpr unsigned kFull = 0xffffffffu;

// The working area's planes: the 8 slot planes the fold reads and writes,
// props (K = 1), then the view's visible lengths and their exclusive sums.
enum Plane {
  TSTART, TLEN, INS_SEQ, INS_CLIENT, REM_SEQ, REM_CLIENT, REM2_SEQ,
  REM2_CLIENT, PROPS, N_STATE
};
constexpr int VBUF = N_STATE, CBUF = N_STATE + 1, N_AREA = N_STATE + 2;
// The op fields read (min_seq drives only the obliterate expiry), pvals last.
enum OpField {
  O_KIND, O_SEQ, O_CLIENT, O_REF, O_A, O_B, O_TSTART, O_TLEN, O_PVALS, N_OPF
};
constexpr int N_OB = 4;  // ob1_seq, ob1_client, ob2_seq, ob2_client
enum Kind { K_PAD = 0, K_INSERT = 1, K_REMOVE = 2, K_RESOLVE = 5 };

constexpr int kTile = 64;                        // op rows a tile
constexpr int kRbuf = N_OPF * kTile;             // the tile's handles
constexpr int kTileWords = (N_OPF + 1) * kTile;
constexpr int kBatch = 4;                        // resolves a pass
constexpr int kMaxTeamWarps = 32;
constexpr int kXWords = 2 * kMaxTeamWarps * kBatch;  // block exchange
constexpr int kWarpTeamMaxS = 128;
constexpr int kMaxWarpTeams = 8;                 // warp teams a block

struct Args {
  const int32_t* op[N_OPF];        // [D, T] each, pvals [D, T, 1]
  const int32_t* st_in[N_STATE];   // [D, S] each (null when cold)
  const int32_t* n_in;             // [D]
  const uint8_t* ov_in;            // [D] (torch.bool)
  const int32_t* ob_in[N_OB];      // [D, S] each (null when cold)
  int32_t* st_out[N_STATE];
  int32_t* n_out;
  uint8_t* ov_out;
  int32_t* resolved;               // [D, T]: each row's handle, or -1
  int32_t* viol;                   // [D]: the stream's violated facts
  int32_t* scratch;                // [D, area_words(S)] (device memory)
  int D, S, T, cold;
};

__host__ __device__ inline size_t area_words(int S) {
  return (size_t)N_AREA * S;
}

// The value pack_matrix_batch fills each plane with.
__device__ __forceinline__ int32_t plane_fill(int p) {
  if (p == INS_CLIENT || p == REM_CLIENT || p == REM2_CLIENT) return -1;
  if (p == REM_SEQ || p == REM2_SEQ) return kNotRemoved;
  return 0;  // tstart, tlen, ins_seq, props
}

__device__ __forceinline__ int32_t ob_fill(int q) {
  return (q & 1) ? -1 : kNotRemoved;
}

#ifdef MATRIX_FOLD_CYCLES
__device__ unsigned long long g_cyc[10];
#define CYC_BEGIN(v) const long long v = clock64()
#define CYC_END(slot, v) cyc_[slot] += clock64() - (v)
#else
#define CYC_BEGIN(v) (void)0
#define CYC_END(slot, v) (void)0
#endif

// -- the team ----------------------------------------------------------------

template <bool kBlock>
struct Team {
  int t, P, lane, warp, nw;
  int32_t* xbuf;  // [2][kMaxTeamWarps][kBatch] (block teams)
  int par;        // which half of xbuf the next exchange takes

  __device__ __forceinline__ void sync() const {
    if constexpr (kBlock) __syncthreads(); else __syncwarp();
  }
  // Exchanges alternate halves: an exchange's half is rewritten two
  // exchanges later, after a barrier every thread passed once done with it.
  __device__ __forceinline__ int32_t* exchange() {
    int32_t* b = xbuf + par * (kMaxTeamWarps * kBatch);
    par ^= 1;
    return b;
  }
};

// Inclusive sums of x[0..kB) over the team in thread order; tot the totals.
template <int kB, bool kBlock>
__device__ __forceinline__ void team_scan(Team<kBlock>& tm, int (&x)[kB],
                                          int (&tot)[kB]) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      const int y = __shfl_up_sync(kFull, x[k], o);
      if (tm.lane >= o) x[k] += y;
    }
  }
  if constexpr (!kBlock) {
#pragma unroll
    for (int k = 0; k < kB; ++k) tot[k] = __shfl_sync(kFull, x[k], 31);
  } else {
    int32_t* buf = tm.exchange();
    if (tm.lane == 31) {
#pragma unroll
      for (int k = 0; k < kB; ++k) buf[tm.warp * kBatch + k] = x[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      int w = tm.lane < tm.nw ? buf[tm.lane * kBatch + k] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, w, o);
        if (tm.lane >= o) w += y;
      }
      const int before = __shfl_sync(kFull, w, tm.warp > 0 ? tm.warp - 1 : 0);
      tot[k] = __shfl_sync(kFull, w, tm.nw - 1);
      if (tm.warp > 0) x[k] += before;
    }
  }
}

// Team-wide maximum (kMax) or sum of x[0..kB), in every thread; also a
// barrier for the team's shared-memory writes before it.
template <bool kMax>
__device__ __forceinline__ int warp_reduce(int x) {
  if constexpr (kMax) return __reduce_max_sync(kFull, x);
  else return (int)__reduce_add_sync(kFull, (unsigned)x);
}

template <int kB, bool kMax, bool kBlock>
__device__ __forceinline__ void team_reduce(Team<kBlock>& tm, int (&x)[kB]) {
#pragma unroll
  for (int k = 0; k < kB; ++k) x[k] = warp_reduce<kMax>(x[k]);
  if constexpr (kBlock) {
    int32_t* buf = tm.exchange();
    if (tm.lane == 0) {
#pragma unroll
      for (int k = 0; k < kB; ++k) buf[tm.warp * kBatch + k] = x[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kB; ++k)
      x[k] = warp_reduce<kMax>(tm.lane < tm.nw ? buf[tm.lane * kBatch + k]
                                               : (kMax ? INT_MIN : 0));
  } else {
    __syncwarp();
  }
}

// -- the stream's working area --------------------------------------------

struct Area {
  int32_t* w;  // [N_AREA][S]
  int S;
  __device__ __forceinline__ int32_t& at(int p, int s) const {
    return w[p * S + s];
  }
};

// A slot's visible length in the (ref, client) view
// (mergetree_kernel._visible_len).  Its obliterate terms read the ob
// clients, which hold their fill -1 on a matrix stream: a removed slot is
// then in the view of client -1 alone.
__device__ __forceinline__ int visible(int tlen, int ins_seq, int ins_client,
                                       int rem, int rem_client,
                                       int rem2_client, int ref, int client) {
  const bool ins_vis = ins_seq <= ref || ins_client == client;
  const bool rem_vis = rem <= ref || rem_client == client
      || rem2_client == client || (rem != kNotRemoved && client == -1);
  return (ins_vis && !rem_vis) ? tlen : 0;
}

// A run of m (1..kBatch) adjacent K_RESOLVE rows from tile row ti, on the
// state they all read: the handle tstart + a - cum of the one visible slot
// with cum <= a < cum + v, written into the tile by the thread holding it
// (the tile's handles start at -1).
template <bool kBlock>
__device__ __forceinline__ void resolve_run(Team<kBlock>& tm, const Area& ar, int32_t* tile,
                            int ti, int m, int nl) {
  int ref[kBatch], cl[kBatch], pos[kBatch], carry[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const bool on = k < m;
    ref[k] = on ? tile[O_REF * kTile + ti + k] : 0;
    cl[k] = on ? tile[O_CLIENT * kTile + ti + k] : 0;
    pos[k] = on ? tile[O_A * kTile + ti + k] : -1;  // -1: never a hit
    carry[k] = 0;
  }
  for (int c0 = 0; c0 < nl; c0 += tm.P) {
    const int s = c0 + tm.t;
    const bool in = s < nl;
    int tlen = 0, is = 0, ic = 0, rs = kNotRemoved, rc = 0, r2c = 0;
    if (in) {
      tlen = ar.at(TLEN, s);
      is = ar.at(INS_SEQ, s);
      ic = ar.at(INS_CLIENT, s);
      rs = ar.at(REM_SEQ, s);
      rc = ar.at(REM_CLIENT, s);
      r2c = ar.at(REM2_CLIENT, s);
    }
    int v[kBatch], x[kBatch], tot[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      v[k] = in ? visible(tlen, is, ic, rs, rc, r2c, ref[k], cl[k]) : 0;
      x[k] = v[k];
    }
    team_scan<kBatch>(tm, x, tot);
    bool more = false;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int cum = carry[k] + x[k] - v[k];
      if (in && cum <= pos[k] && pos[k] < cum + v[k])
        tile[kRbuf + ti + k] = ar.at(TSTART, s) + pos[k] - cum;
      carry[k] += tot[k];
      more |= carry[k] <= pos[k];  // a later slot may still hold a
    }
    if (!more) break;
  }
}

// What a folding row's one view found (team-uniform).
struct View {
  int ia;    // slot split at a, or -1
  int ib;    // slot split at b (removes), or -1
  int ja;    // first live slot with cum >= a, else nl
  int vend;  // v / cum are stored for slots [0, vend)
};

// v / cum over the live slots, a chunk of the team's width at a time, and
// the searches on them.  Visible slots' open intervals are disjoint, so at
// most one thread finds each split; ja - 1 is the last slot with cum < a,
// which the thread holding it finds from its own cum + v.  Stops after the
// chunk whose running sum reaches max(a, b) (a for inserts): every later
// slot has cum >= it, so none can be split, be the tie-break slot's
// predecessor or be stamped.
template <bool kBlock>
__device__ __forceinline__ View view_row(Team<kBlock>& tm, const Area& ar, int nl, int ref,
                         int client, int a, int b, bool is_ins) {
  const int stop_at = is_ins ? a : max(a, b);
  int found[3] = {-1, -1, 0};
  int carry = 0, vend = 0;
  for (int c0 = 0; c0 < nl; c0 += tm.P) {
    const int s = c0 + tm.t;
    const bool in = s < nl;
    const int v = in ? visible(ar.at(TLEN, s), ar.at(INS_SEQ, s),
                               ar.at(INS_CLIENT, s), ar.at(REM_SEQ, s),
                               ar.at(REM_CLIENT, s), ar.at(REM2_CLIENT, s),
                               ref, client)
                     : 0;
    int x[1] = {v}, tot[1];
    team_scan<1>(tm, x, tot);
    const int cum = carry + x[0] - v;
    if (in) {
      ar.at(VBUF, s) = v;
      ar.at(CBUF, s) = cum;
      if (cum < a && a < cum + v) found[0] = s;
      if (!is_ins && cum < b && b < cum + v) found[1] = s;
      if (cum < a && (cum + v >= a || s == nl - 1)) found[2] = s + 1;
    }
    carry += tot[0];
    vend = min(c0 + tm.P, nl);
    if (carry >= stop_at) break;
  }
  team_reduce<3, true>(tm, found);  // also publishes v / cum
  return View{found[0], found[1], found[2], vend};
}

// The row's one move over pre-row slots [lo, hi), top down in chunks of
// the team's width: every slot read, then written once at its final place,
// split into its pieces and (removes) stamped; the destinations of all
// pieces are distinct and a chunk writes only at or above its own first
// slot, so one barrier a chunk suffices.  Returns whether a piece met a
// third remover (overflow).
template <bool kBlock>
__device__ __forceinline__ bool move_row(Team<kBlock>& tm, const Area& ar, const View& w,
                         bool is_ins, bool cut_a, bool cut_b, int a, int b,
                         int seq, int client, int lo, int hi) {
  const int S = ar.S;
  bool over = false;
  for (int top = hi; top > lo; top -= tm.P) {
    const int s = top - tm.P + tm.t;
    const bool act = s >= lo;
    int32_t x[N_STATE];
    int np = 0, base = 0, c = 0, v = 0, cut0 = 0, cut1 = 0;
    if (act) {
#pragma unroll
      for (int p = 0; p < N_STATE; ++p) x[p] = ar.at(p, s);
      if (s < w.vend) {
        c = ar.at(CBUF, s);
        v = ar.at(VBUF, s);
      }
      const bool sa = cut_a && s == w.ia, sb = cut_b && s == w.ib;
      np = 1 + sa + sb;
      cut0 = sa && sb ? min(a, b) : (sa ? a : b);
      cut1 = max(a, b);
      base = s + (cut_a && w.ia < s) + (cut_b && w.ib < s);
    }
    tm.sync();  // the chunk is read before any of it is overwritten
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k >= np) break;
      const int start = k == 0 ? c : (k == 1 ? cut0 : cut1);
      const int end = k + 1 == np ? c + v : (k == 0 ? cut0 : cut1);
      int32_t y[N_STATE];
#pragma unroll
      for (int p = 0; p < N_STATE; ++p) y[p] = x[p];
      if (np > 1) {
        y[TSTART] = x[TSTART] + (start - c);
        y[TLEN] = end - start;
      }
      if (!is_ins && s < w.vend) {
        const bool covered = start >= a && end <= b && end > start;
        const bool again = covered && y[REM_SEQ] != kNotRemoved;
        over |= again && y[REM2_SEQ] != kNotRemoved;  // a third remover
        if (covered && !again) {
          y[REM_SEQ] = seq;
          y[REM_CLIENT] = client;
        } else if (again && y[REM2_SEQ] == kNotRemoved) {
          y[REM2_SEQ] = seq;
          y[REM2_CLIENT] = client;
        }
      }
      const int p = base + k;
      const int dst = p + (is_ins && p >= w.ja);
      if (dst < S) {
#pragma unroll
        for (int q = 0; q < N_STATE; ++q) ar.at(q, dst) = y[q];
      }
    }
  }
  return over;
}

// -- the kernel ----------------------------------------------------------------

// kMode 0: a warp team a stream, shared memory; 1: the block a stream,
// shared memory; 2: the block a stream, its area in device memory.
template <int kMode>
__global__ void __launch_bounds__(kMode == 0 ? 32 * kMaxWarpTeams : 1024,
                                  kMode == 0 ? 4 : 1)
matrix_fold_kernel(Args a) {
  constexpr bool kBlock = kMode != 0;
  extern __shared__ __align__(16) int32_t smem[];
  const int S = a.S, T = a.T;
  Team<kBlock> tm;
  int d;
  int32_t* tile;
  int32_t* area;
  if constexpr (kBlock) {
    d = blockIdx.x;
    tm.t = threadIdx.x;
    tm.P = blockDim.x;
    tm.xbuf = smem;
    tile = smem + kXWords;
    area = kMode == 2 ? a.scratch + (size_t)d * area_words(S)
                      : tile + kTileWords;
  } else {
    const int team = threadIdx.x >> 5;
    d = blockIdx.x * (blockDim.x >> 5) + team;
    tm.t = threadIdx.x & 31;
    tm.P = 32;
    tm.xbuf = nullptr;
    tile = smem + (size_t)team * (kTileWords + area_words(S));
    area = tile + kTileWords;
    if (d >= a.D) return;  // a warp team waits on no other warp
  }
  tm.lane = threadIdx.x & 31;
  tm.warp = tm.t >> 5;
  tm.nw = tm.P >> 5;
  tm.par = 0;
  const Area ar{area, S};
  const size_t dS = (size_t)d * S, dT = (size_t)d * T;
#ifdef MATRIX_FOLD_CYCLES
  long long cyc_[6] = {0, 0, 0, 0, 0, 0}, nres_ = 0, nfold_ = 0;
  const long long t0_ = clock64();
#endif

  CYC_BEGIN(in_);
  int viol = 0, n;
  bool overflow;
  if (a.cold) {
    // No state is read: every plane's pack fill, n = 0.
    n = 0;
    overflow = false;
    for (int p = 0; p < N_STATE; ++p) {
      const int32_t f = plane_fill(p);
      int4* dst = reinterpret_cast<int4*>(area + (size_t)p * S);
      for (int i = tm.t; i < S / 4; i += tm.P) dst[i] = make_int4(f, f, f, f);
    }
  } else {
    n = a.n_in[d];
    overflow = a.ov_in[d] != 0;
    // Every plane's vector in flight before any is stored.
    for (int i = tm.t; i < S / 4; i += tm.P) {
      int4 r[N_STATE];
#pragma unroll
      for (int p = 0; p < N_STATE; ++p)
        r[p] = reinterpret_cast<const int4*>(a.st_in[p] + dS)[i];
#pragma unroll
      for (int p = 0; p < N_STATE; ++p)
        reinterpret_cast<int4*>(area + (size_t)p * S)[i] = r[p];
    }
    const int nl = min(n, S);
    for (int s = tm.t; s < nl; s += tm.P) {
#pragma unroll
      for (int q = 0; q < N_OB; ++q) viol += a.ob_in[q][dS + s] != ob_fill(q);
    }
  }
  CYC_END(0, in_);

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int tl = min(kTile, T - t0);
    CYC_BEGIN(tile_);
    tm.sync();  // the previous tile is consumed and its handles written
    for (int i = tm.t; i < tl / 4; i += tm.P) {
      int4 r[N_OPF];  // every field's vector in flight before any store
#pragma unroll
      for (int f = 0; f < N_OPF; ++f)
        r[f] = reinterpret_cast<const int4*>(a.op[f] + dT + t0)[i];
#pragma unroll
      for (int f = 0; f < N_OPF; ++f)
        reinterpret_cast<int4*>(tile + f * kTile)[i] = r[f];
    }
    for (int i = tm.t; i < tl; i += tm.P) tile[kRbuf + i] = -1;
    tm.sync();
    for (int i = tm.t; i < tl; i += tm.P) {
      const int kind = tile[O_KIND * kTile + i];
      viol += (kind != K_PAD && kind != K_INSERT && kind != K_REMOVE
               && kind != K_RESOLVE)
          + (tile[O_PVALS * kTile + i] != kPropNotTouched);
    }
    CYC_END(0, tile_);
    for (int ti = 0; ti < tl; ++ti) {
      const int kind = tile[O_KIND * kTile + ti];
      if (kind == K_RESOLVE) {  // reads: resolve on the current state
        int m = 1;
        while (m < kBatch && ti + m < tl
               && tile[O_KIND * kTile + ti + m] == K_RESOLVE)
          ++m;
        CYC_BEGIN(res_);
        resolve_run(tm, ar, tile, ti, m, min(n, S));
        CYC_END(1, res_);
#ifdef MATRIX_FOLD_CYCLES
        nres_ += m;
#endif
        ti += m - 1;
        continue;
      }
      if (kind != K_INSERT && kind != K_REMOVE) continue;  // inert
      const int seq = tile[O_SEQ * kTile + ti];
      const int client = tile[O_CLIENT * kTile + ti];
      const int ra = tile[O_A * kTile + ti];
      const int rb = tile[O_B * kTile + ti];
      const bool is_ins = kind == K_INSERT;
      const int nl = min(n, S);  // live slots held
#ifdef MATRIX_FOLD_CYCLES
      ++nfold_;
#endif
      CYC_BEGIN(view_);
      const View w = view_row(tm, ar, nl, tile[O_REF * kTile + ti], client,
                              ra, rb, is_ins);
      CYC_END(2, view_);
      const bool cut_a = w.ia >= 0;
      const bool cut_b = !is_ins && w.ib >= 0 && !(w.ib == w.ia && rb == ra);
      CYC_BEGIN(move_);
      if (is_ins) {
        move_row(tm, ar, w, true, cut_a, false, ra, rb, seq, client,
                 cut_a ? w.ia : w.ja, nl);
        if (tm.t == 0 && w.ja < S) {
          // The new slot; its arrival kill never fires on a matrix stream.
          ar.at(TSTART, w.ja) = tile[O_TSTART * kTile + ti];
          ar.at(TLEN, w.ja) = tile[O_TLEN * kTile + ti];
          ar.at(INS_SEQ, w.ja) = seq;
          ar.at(INS_CLIENT, w.ja) = client;
          ar.at(REM_SEQ, w.ja) = kNotRemoved;
          ar.at(REM_CLIENT, w.ja) = -1;
          ar.at(REM2_SEQ, w.ja) = kNotRemoved;
          ar.at(REM2_CLIENT, w.ja) = -1;
          ar.at(PROPS, w.ja) = kPropAbsent;
        }
        tm.sync();
        n += 1 + cut_a;
      } else {
        int lo = w.ja;
        if (cut_a) lo = min(lo, w.ia);
        if (cut_b) lo = min(lo, w.ib);
        const int hi = (cut_a || cut_b) ? nl : w.vend;
        int over[1] = {move_row(tm, ar, w, false, cut_a, cut_b, ra, rb, seq,
                                client, lo, hi) ? 1 : 0};
        team_reduce<1, true>(tm, over);
        overflow |= over[0] != 0;
        n += cut_a + cut_b;
      }
      CYC_END(4, move_);
    }
    CYC_BEGIN(out_);
    tm.sync();  // the tile's handles are in
    int4* res = reinterpret_cast<int4*>(a.resolved + dT + t0);
    for (int i = tm.t; i < tl / 4; i += tm.P)
      res[i] = reinterpret_cast<const int4*>(tile + kRbuf)[i];
    CYC_END(5, out_);
  }

  CYC_BEGIN(back_);
  int vv[1] = {viol};
  team_reduce<1, false>(tm, vv);
  for (int i = tm.t; i < S / 4; i += tm.P) {
#pragma unroll
    for (int p = 0; p < N_STATE; ++p)
      reinterpret_cast<int4*>(a.st_out[p] + dS)[i] =
          reinterpret_cast<const int4*>(area + (size_t)p * S)[i];
  }
  if (tm.t == 0) {
    a.n_out[d] = n;
    a.ov_out[d] = overflow ? 1 : 0;
    a.viol[d] = vv[0];
  }
  CYC_END(5, back_);
#ifdef MATRIX_FOLD_CYCLES
  if (tm.t == 0) {
    for (int i = 0; i < 6; ++i)
      atomicAdd(&g_cyc[i], (unsigned long long)cyc_[i]);
    atomicAdd(&g_cyc[6], (unsigned long long)nres_);
    atomicAdd(&g_cyc[7], (unsigned long long)nfold_);
    atomicMax(&g_cyc[8], (unsigned long long)(clock64() - t0_));
    atomicAdd(&g_cyc[9], 1ull);
  }
#endif
}

// -- launch shapes ---------------------------------------------------------

const void* kernel_of(int mode) {
  if (mode == 0) return reinterpret_cast<const void*>(&matrix_fold_kernel<0>);
  if (mode == 1) return reinterpret_cast<const void*>(&matrix_fold_kernel<1>);
  return reinterpret_cast<const void*>(&matrix_fold_kernel<2>);
}

struct Shape {
  int mode;             // kMode of the build
  int threads;          // a block
  int teams;            // streams a block
  int blocks_per_sm;    // cudaOccupancyMaxActiveBlocksPerMultiprocessor
  size_t smem;          // dynamic shared memory a block
};

struct ShapeEntry {
  int dev, S;
  Shape shape;
};
std::mutex g_shapes_mu;
std::vector<ShapeEntry> g_shapes;

// S <= 128: warp teams, the teams a block (1, 2, 4 or 8) that keep the most
// streams resident per SM (fewer on a tie).  Else the block is the team,
// S / 16 threads (64 to 1,024), in shared memory when its area fits a block.
// Measured at S = 4,096 (tools/torch_kernel_turns.py, H100, 700 W): S / 4
// threads took 1.71 ms, S / 8 1.16, S / 16 1.11: every thread of the team
// runs each row's scans and barriers, and a stream's ~550 live slots need
// no more than a few chunks.
cudaError_t find_shape(int dev, int S, Shape* out) {
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (S <= kWarpTeamMaxS) {
    const void* k = kernel_of(0);
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    const size_t per = (kTileWords + area_words(S)) * sizeof(int32_t);
    Shape best{0, 0, 0, 0, 0};
    for (int w = 1; w <= kMaxWarpTeams; w *= 2) {
      if (w * per > (size_t)optin) break;
      int blocks = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, w * 32,
                                                        w * per);
      if (e != cudaSuccess) return e;
      if (blocks * w > best.blocks_per_sm * best.teams)
        best = Shape{0, w * 32, w, blocks, w * per};
    }
    if (best.teams == 0) return cudaErrorInvalidConfiguration;
    *out = best;
    return cudaSuccess;
  }
  int threads = (S / 16 + 31) / 32 * 32;
  threads = threads < 64 ? 64 : (threads > 1024 ? 1024 : threads);
  const size_t full =
      (kXWords + kTileWords + area_words(S)) * sizeof(int32_t);
  const int mode = full <= (size_t)optin ? 1 : 2;
  const size_t bytes =
      mode == 1 ? full : (kXWords + kTileWords) * sizeof(int32_t);
  const void* k = kernel_of(mode);
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads,
                                                    bytes);
  if (e != cudaSuccess) return e;
  if (blocks == 0) return cudaErrorInvalidConfiguration;
  *out = Shape{mode, threads, 1, blocks, bytes};
  return cudaSuccess;
}

cudaError_t launch_shape(int S, Shape* out) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(g_shapes_mu);
  for (const ShapeEntry& c : g_shapes) {
    if (c.dev == dev && c.S == S) {
      *out = c.shape;
      return cudaSuccess;
    }
  }
  e = find_shape(dev, S, out);
  if (e == cudaSuccess) g_shapes.push_back(ShapeEntry{dev, S, *out});
  return e;
}

}  // namespace

extern "C" {

#ifdef MATRIX_FOLD_CYCLES
// The phase counters, summed over every launch since the last call (the
// slowest stream's total a maximum): copy in, resolves, views, (no arrival
// kill), moves, write-back, resolve rows, folding rows, slowest stream,
// streams.  Reads and resets them.
int matrix_fold_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[10] = {};
  return (int)cudaMemcpyToSymbol(g_cyc, zero, sizeof(g_cyc));
}
#endif

// Bytes of one stream's working area: its slice of the device-memory
// scratch when it folds there.
long long matrix_fold_area_bytes(int S) {
  return (long long)(area_words(S) * sizeof(int32_t));
}

// The launch the fold takes at S on the current device: out = {mode (0
// warp teams, 1 block teams in shared memory, 2 block teams in device
// memory), threads a block, streams a block, blocks per SM, dynamic shared
// memory a block}.  Returns a CUDA error (0 = found).
int matrix_fold_launch_shape(int S, int* out) {
  if (S < 4 || S % 4) return (int)cudaErrorInvalidValue;
  Shape shape;
  const cudaError_t e = launch_shape(S, &shape);
  if (e != cudaSuccess) return (int)e;
  out[0] = shape.mode;
  out[1] = shape.threads;
  out[2] = shape.teams;
  out[3] = shape.blocks_per_sm;
  out[4] = (int)shape.smem;
  return 0;
}

// The fold.  ptrs: the 9 op fields read (kind, seq, client, ref_seq, a, b,
// tstart, tlen, pvals), the 9 state planes in (8 slot planes and props),
// n, overflow, the 4 obliterate planes (all null when cold), the 9 planes,
// n and overflow out, resolved [D, T], viol [D], the scratch (device
// memory, else null).  iargs: D, S, T, cold.  S and T are multiples of 4
// and every row starts 16-byte aligned (the wrapper checks).  Returns
// cudaGetLastError() after the launch (0 = launched).
int matrix_fold_resolve(void* const* ptrs, const int* iargs, void* stream) {
  Args a = {};
  int i = 0;
  for (int f = 0; f < N_OPF; ++f) a.op[f] = (const int32_t*)ptrs[i++];
  for (int p = 0; p < N_STATE; ++p) a.st_in[p] = (const int32_t*)ptrs[i++];
  a.n_in = (const int32_t*)ptrs[i++];
  a.ov_in = (const uint8_t*)ptrs[i++];
  for (int q = 0; q < N_OB; ++q) a.ob_in[q] = (const int32_t*)ptrs[i++];
  for (int p = 0; p < N_STATE; ++p) a.st_out[p] = (int32_t*)ptrs[i++];
  a.n_out = (int32_t*)ptrs[i++];
  a.ov_out = (uint8_t*)ptrs[i++];
  a.resolved = (int32_t*)ptrs[i++];
  a.viol = (int32_t*)ptrs[i++];
  a.scratch = (int32_t*)ptrs[i++];
  a.D = iargs[0];
  a.S = iargs[1];
  a.T = iargs[2];
  a.cold = iargs[3];
  if (a.D == 0) return 0;
  if (a.S < 4 || a.S % 4 || a.T < 4 || a.T % 4)
    return (int)cudaErrorInvalidValue;
  if (!a.cold && (a.st_in[0] == nullptr || a.ob_in[0] == nullptr))
    return (int)cudaErrorInvalidValue;
  Shape shape;
  const cudaError_t e = launch_shape(a.S, &shape);
  if (e != cudaSuccess) return (int)e;
  if (shape.mode == 2 && a.scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const int blocks = (a.D + shape.teams - 1) / shape.teams;
  cudaStream_t s = (cudaStream_t)stream;
  if (shape.mode == 0)
    matrix_fold_kernel<0><<<blocks, shape.threads, shape.smem, s>>>(a);
  else if (shape.mode == 1)
    matrix_fold_kernel<1><<<blocks, shape.threads, shape.smem, s>>>(a);
  else
    matrix_fold_kernel<2><<<blocks, shape.threads, shape.smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
