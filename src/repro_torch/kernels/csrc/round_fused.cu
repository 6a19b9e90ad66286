// One simulator step's C SWRR request rounds, fused, over every SM.
//
// Replaces the TPU kernel repro/kernels/round_fused.py::round_step_swrr
// (body _round_kernel). Per round r and player k: SWRR selection on the
// (M,) credits, latency rtt + (q + 1) * s_m * z on the shared queue,
// the consecutive-error counter with its cooldown trip, pool and weight
// renormalisation, one latency-ring and one reward-ring write; between
// rounds the round's arrivals land on the shared (M,) queue, which
// drains served_per_round before the next round reads it.
//
// What bounds it on the H100: bytes. The function reads the (K, M)
// state and the rings and writes new ones (~62 MB at K = 1000, M = 50,
// R = 64, Rq = 512: ~19 us at 3.35 TB/s) and does O(C * K * M) work.
// What stands between it and that bound is the round-to-round coupling:
// every player of round r reads the queue after round r - 1's arrivals.
//
// Design:
// - A cooperative grid, every CTA resident (the wrapper sizes it from
//   the occupancy query: a warp for each player where that fits, else
//   every resident CTA). A warp owns players gw, gw + W, ... (W player
//   warps in the grid). A CTA has up to 8 player warps and kCopyWarps
//   copy warps.
// - A warp's player keeps its (M,) rows of weights, credits, counters,
//   cooldowns, latencies and pool bits, its C noise draws and its
//   request count in the warp's slice of shared memory for all C
//   rounds: loaded once, coalesced, and stored once. A warp with more
//   than one player (K above the resident warps) loads and stores each
//   player's rows every round, still coalesced, through L2.
// - Lanes hold the arms (m = lane + 32 j): credits, argmax (redux.sync
//   on an order-preserving key, then on the lowest arm holding it), the
//   fallback counts (ballots) and the renormalisation run lane-parallel.
//   The two ordered sums run serially on lane 0.
// - One grid barrier per round. Before it each CTA adds its players'
//   arrivals (summed in shared memory) onto the round's (S, M) rows of
//   a workspace; after it every CTA recomputes the queue from that row in
//   shared memory, in the plain version's op order, so every CTA holds
//   the same queue and no second barrier is needed. The arrivals are
//   integer-valued float32 counts: their sum is exact in any order
//   below 2^24. The barrier is a counter in the workspace (zeroed by
//   the wrapper for every call): thread 0 adds with release semantics
//   after the CTA synchronises and spins with acquire loads.
// - Only a round's arrivals feed the barrier, and they need only the
//   round's pick. So a warp with one player makes its request before
//   the barrier and runs the rest of the round (latency on the queue
//   before this round's arrivals, feedback control, renormalisation,
//   outputs) and the next round's SWRR selection between arriving and
//   waiting, hidden behind the barrier's latency.
// - The rings (lat/ts (K, M, R), r/rts (K, Rq)) are never read by the
//   rounds. The copy warps stream them input to output with 16-byte
//   accesses for the whole call, overlapping the rounds, and meet the
//   player warps at a CTA barrier before the last grid barrier, which
//   orders the copy before each warp writes its players' <= C ring
//   slots in the sequential core.bandit.record order.
// - Lanes: a call may carry S independent simulations. The players are
//   S * Kl rows, lane s owning rows [s * Kl, (s + 1) * Kl); the
//   per-instance rows (queue, arrivals, s_m, served, active) are (S, M),
//   and a CTA keeps all S lanes' rows in shared memory. A player reads
//   and feeds only its own lane's rows; a round's workspace row is
//   (S, M), and every CTA recomputes every lane's queue after the one
//   grid barrier. S = 1 is the single simulation.
// Every input is read once and every output written once (the rows of
// a warp with several players excepted).
//
// Exactness against the plain version: the argmax keeps the first
// maximal index (the largest credit, ties to the lower arm; -0.0 keyed
// as 0.0); the SWRR total and the renormalising wsum add the M columns
// left to right (wsum is the total itself unless the round trips, as
// the columns are then the same); a tripped arm's cooldown deadline
// comes in as a number (t_cd, rounded by the caller); the latency chain
// uses explicit round-to-nearest intrinsics, and the library is built
// with --fmad=false, so no a*b+c becomes an FMA except the one the
// reference has: lat = fma((q + 1) * s, z, rtt), which XLA:CPU
// contracts and the plain version rounds once as well; each new weight
// is one IEEE division (a zero numerator gives its own zero).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPlayerWarps = 8;   // at most, a CTA
constexpr int kCopyWarps = 4;     // warps a CTA that stream the rings
constexpr int kCopyUnroll = 4;    // 16-byte loads in flight a copy thread

struct RoundArgs {
  const float* weights;     // (K, M)
  const float* cw;          // (K, M)
  const int32_t* err;       // (K, M)
  const float* cooldown;    // (K, M)
  const uint8_t* in_pool;   // (K, M) bool
  const uint8_t* active;    // (S, M) bool
  const float* lat_buf;     // (K, M, R)
  const float* ts_buf;      // (K, M, R)
  const int32_t* ptr;       // (K, M)
  const float* r_buf;       // (K, Rq)
  const float* rts_buf;     // (K, Rq)
  const int32_t* rptr;      // (K,)
  const float* q_in;        // (S, M)
  const int32_t* nc;        // (K,)
  const float* z;           // (C, K)
  const float* rtt;         // (K, M)
  const float* s_m;         // (S, M)
  const float* served;      // (S, M)
  float* w_o;               // outputs, shaped as their inputs
  float* cw_o;
  int32_t* err_o;
  float* cd_o;
  uint8_t* pool_o;
  float* lat_o;
  float* ts_o;
  int32_t* ptr_o;
  float* rb_o;
  float* rts_o;
  int32_t* rptr_o;
  float* q_out;             // (S, M)
  float* arrivals;          // (S, M)
  int32_t* choices;         // (K, C)
  float* lats;              // (K, C)
  float* procs;             // (K, C)
  unsigned int* bar;        // workspace word 0: the barrier counter
  float* arr_ws;            // workspace from word 32: (C, S, M) arrivals
  int K, M, R, Rq, C;       // K: the players of all lanes
  int S, Kl;                // lanes, players a lane
  int player_warps;         // warps a CTA that run players; kCopyWarps more copy
  int ppw;                  // players per warp (1: rows stay resident)
  float t, tau, t_cd;        // t_cd: a tripped arm's cooldown deadline
  int err_thresh;
};

// A warp's player in shared memory: its rows, its latency row, its
// noise for every round and its request count.
struct Row {
  float* w;
  float* cw;
  float* cd;
  float* rtt;
  int32_t* err;
  int32_t* ptr;
  float* z;                 // (C,)
  int32_t* nc;              // one word
  uint8_t* pool;
};

// Barrier 1 among the player warps only (the copy warps never wait).
__device__ __forceinline__ void sync_players(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// The grid barrier: thread 0 of each CTA adds one with release
// semantics once its CTA has synchronised (so every write the CTA made
// before is ordered before the add) and spins with acquire loads until
// every CTA has added; the CTA synchronises again after.
__device__ __forceinline__ void grid_arrive(unsigned int* bar) {
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar) : "memory");
}

__device__ __forceinline__ void grid_wait(unsigned int* bar, unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(bar)
                   : "memory");
    } while (seen < target);
  }
}

// dst[0:n] = src[0:n] over `nth` threads (this one `tid`): 16-byte
// accesses, kCopyUnroll in flight a thread, when both pointers allow.
__device__ void copy_all(float* dst, const float* src, size_t n, size_t tid,
                         size_t nth) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
       15) != 0) {
    for (size_t j = tid; j < n; j += nth) dst[j] = src[j];
    return;
  }
  const size_t n4 = n / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  size_t i = tid;
  for (; i + (kCopyUnroll - 1) * nth < n4; i += kCopyUnroll * nth) {
    float4 v[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) v[u] = __ldcs(s4 + i + u * nth);
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) d4[i + u * nth] = v[u];
  }
  for (; i < n4; i += nth) d4[i] = __ldcs(s4 + i);
  for (size_t j = n4 * 4 + tid; j < n; j += nth) dst[j] = src[j];
}

// The copy warps: the rings, input to output, split over every copy
// thread of the grid.
__device__ void copy_rings(const RoundArgs& a) {
  const size_t per_cta = 32 * kCopyWarps;
  const size_t tid = blockIdx.x * per_cta + (threadIdx.x - 32 * a.player_warps);
  const size_t nth = gridDim.x * per_cta;
  const size_t n_lat = static_cast<size_t>(a.K) * a.M * a.R;
  const size_t n_r = static_cast<size_t>(a.K) * a.Rq;
#pragma unroll 1
  for (int i = 0; i < 4; ++i)
    copy_all(i == 0 ? a.lat_o : i == 1 ? a.ts_o : i == 2 ? a.rb_o : a.rts_o,
             i == 0 ? a.lat_buf : i == 1 ? a.ts_buf : i == 2 ? a.r_buf : a.rts_buf,
             i < 2 ? n_lat : n_r, tid, nth);
}

// Player k into the warp's shared memory: the rows from the inputs in
// round 0, else from the outputs the warp stored last round; its
// latency row, noise and request count.
__device__ void load_row(const RoundArgs& a, const Row& row, int k, bool first,
                         int lane) {
  const size_t base = static_cast<size_t>(k) * a.M;
  const float* w = first ? a.weights : a.w_o;
  const float* cw = first ? a.cw : a.cw_o;
  const int32_t* err = first ? a.err : a.err_o;
  const float* cd = first ? a.cooldown : a.cd_o;
  const uint8_t* pool = first ? a.in_pool : a.pool_o;
#pragma unroll 1
  for (int m = lane; m < a.M; m += 32) {
    row.w[m] = w[base + m];
    row.cw[m] = cw[base + m];
    row.err[m] = err[base + m];
    row.cd[m] = cd[base + m];
    row.pool[m] = pool[base + m];
    row.rtt[m] = a.rtt[base + m];
  }
#pragma unroll 1
  for (int r = lane; r < a.C; r += 32) row.z[r] = a.z[static_cast<size_t>(r) * a.K + k];
  if (lane == 0) *row.nc = a.nc[k];
  __syncwarp();
}

__device__ void store_row(const RoundArgs& a, const Row& row, int k, int lane) {
  __syncwarp();
  const size_t base = static_cast<size_t>(k) * a.M;
#pragma unroll 1
  for (int m = lane; m < a.M; m += 32) {
    a.w_o[base + m] = row.w[m];
    a.cw_o[base + m] = row.cw[m];
    a.err_o[base + m] = row.err[m];
    a.cd_o[base + m] = row.cd[m];
    a.pool_o[base + m] = row.pool[m];
  }
}

// x[0] + x[1] + ... + x[M-1], left to right, with x[skip] taken as 0;
// x is 16-byte aligned and padded to a multiple of 4 floats.
__device__ float row_sum(const float* x, int M, int skip) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float s = 0.f;
#pragma unroll 4
  for (int j = 0; 4 * j < M; ++j) {
    const float4 v = x4[j];
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int m = 4 * j + u;
      const float xm = m == skip ? 0.f : e[u];
      if (m == 0) s = xm;
      else if (m < M) s = __fadd_rn(s, xm);
    }
  }
  return s;
}

// An unsigned key in the order of the float (-0.0 taken as 0.0, which
// it equals).
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A round's SWRR pick: the arm and the total it was charged.
struct Pick {
  int choice;
  float total;
};

// The player's SWRR selection (core.swrr.swrr_select) for its next
// round, by the whole warp: credits += weights, the first maximal
// credit, which is charged the total. It reads only the rows, not the
// queue. Every lane touches only its own arms m = lane + 32 j, lane 0
// also reads them all for the ordered sum. Ends with the warp in step.
__device__ Pick select(const Row& row, int M, int lane) {
  float total = lane == 0 ? row_sum(row.w, M, -1) : 0.f;
  float best = 0.f;
  int choice = -1;
#pragma unroll 1
  for (int m = lane; m < M; m += 32) {
    const float c = __fadd_rn(row.cw[m], row.w[m]);
    row.cw[m] = c;
    if (choice < 0 || c > best) {
      best = c;
      choice = m;
    }
  }
  // the warp's largest credit, then the lowest arm holding it
  const unsigned key = choice < 0 ? 0u : ordered(best);
  const unsigned top = __reduce_max_sync(kFull, key);
  choice = __reduce_min_sync(kFull, choice >= 0 && key == top ? choice : INT_MAX);
  total = __shfl_sync(kFull, total, 0);
  if ((choice & 31) == lane) row.cw[choice] = __fsub_rn(row.cw[choice], total);
  __syncwarp();
  return Pick{choice, total};
}

// The rest of round r of player k, by the whole warp, once its pick is
// known: the latency on the queue before this round's arrivals, the
// feedback control, the renormalised weights and the per-request
// outputs. Ends with the warp in step.
__device__ void finish(const RoundArgs& a, const Row& row, int k, int r,
                       Pick pick, const float* q_s, const float* s_s,
                       const uint8_t* act_s, int lane, float t_cd) {
  const int M = a.M;
  const bool mask = r < *row.nc;
  const int choice = pick.choice;
  const bool owner = (choice & 31) == lane;

  // --- latency on the shared queue: rtt + ((q + 1) * s) * z, the sum
  // fused with the product into one rounding, as the reference's
  // compiler emits it ---
  const float q1s = __fmul_rn(__fadd_rn(q_s[choice], 1.f), s_s[choice]);
  const float z = row.z[r];
  const float proc = __fmul_rn(q1s, z);
  const float lat = __fmaf_rn(q1s, z, row.rtt[choice]);

  // --- feedback control (core.bandit._record_control) ---
  const bool reward = lat <= a.tau;
  const int old_err = row.err[choice];
  const int new_err = reward ? 0 : old_err + 1;
  const bool trip = mask && new_err >= a.err_thresh;
  __syncwarp();                     // every lane has read err[choice]
  if (owner) {
    row.err[choice] = mask ? (trip ? 0 : new_err) : old_err;
    if (trip) {
      row.cd[choice] = t_cd;
      row.pool[choice] = 0;
    }
  }
  // the columns of wsum are the total's unless the round trips
  float wsum = pick.total;
  if (trip) {
    wsum = lane == 0 ? row_sum(row.w, M, choice) : 0.f;
    wsum = __shfl_sync(kFull, wsum, 0);
  }
  __syncwarp();
  // the arms left in the pool and the active arms (the tripped one
  // excepted), counted in one pass: the fallback takes the first set
  // unless it is empty
  int n_rem = 0, n_act = 0;
#pragma unroll 1
  for (int m0 = 0; m0 < M; m0 += 32) {
    const int m = m0 + lane;
    const bool act = m < M && act_s[m] != 0;
    const bool pool = m < M && row.pool[m] != 0;
    n_rem += __popc(__ballot_sync(kFull, act && pool));
    n_act += __popc(__ballot_sync(kFull, act && !(trip && m == choice)));
  }
  const bool rem_any = n_rem > 0;
  // w2 / wsum, or the fallback share, as one division (+-0 / d is +-0)
  const bool renorm = wsum > 0.f;
  const float den = renorm ? fmaxf(wsum, 1e-30f)
                           : fmaxf(static_cast<float>(rem_any ? n_rem : n_act), 1.f);
#pragma unroll 1
  for (int m = lane; m < M; m += 32) {
    const bool tripped = trip && m == choice;
    const bool act = act_s[m] != 0;
    const bool fb = rem_any ? act && row.pool[m] != 0 : act && !tripped;
    const float num = renorm ? (tripped ? 0.f : row.w[m]) : (fb ? 1.f : 0.f);
    row.w[m] = num == 0.f ? num : __fdiv_rn(num, den);
    if (tripped) row.cw[m] = 0.f;
  }

  // --- per-request outputs; the ring writes wait for the last barrier ---
  if (lane == 0) {
    const size_t out = static_cast<size_t>(k) * a.C + r;
    a.choices[out] = choice;
    a.lats[out] = lat;
    a.procs[out] = proc;
  }
  __syncwarp();
}

// Round r's request of the warp's player onto the CTA's arrivals of
// its lane (arr_s is that lane's row).
__device__ __forceinline__ void request(const Row& row, int r, Pick pick,
                                       float* arr_s, int lane) {
  if (lane == 0 && r < *row.nc) atomicAdd(&arr_s[pick.choice], 1.f);
}

// Player k's ring slots, sequential core.bandit.record semantics, and
// its ring pointers; after the last barrier, so after the ring copy.
__device__ void ring_writes(const RoundArgs& a, const Row& row, int k, int lane) {
  const size_t base = static_cast<size_t>(k) * a.M;
#pragma unroll 1
  for (int m = lane; m < a.M; m += 32) row.ptr[m] = a.ptr[base + m];
  __syncwarp();
  if (lane == 0) {
    const int n = a.nc[k];
    int rp = a.rptr[k];
    for (int r = 0; r < a.C && r < n; ++r) {
      const size_t out = static_cast<size_t>(k) * a.C + r;
      const int ch = a.choices[out];
      const float lat = a.lats[out];
      const int p = row.ptr[ch];
      const size_t slot = (base + ch) * a.R + p;
      a.lat_o[slot] = lat;
      a.ts_o[slot] = a.t;
      row.ptr[ch] = (p + 1) % a.R;
      const size_t rs = static_cast<size_t>(k) * a.Rq + rp;
      a.rb_o[rs] = lat <= a.tau ? 1.f : 0.f;
      a.rts_o[rs] = a.t;
      rp = (rp + 1) % a.Rq;
    }
    a.rptr_o[k] = rp;
  }
  __syncwarp();
#pragma unroll 1
  for (int m = lane; m < a.M; m += 32) a.ptr_o[base + m] = row.ptr[m];
  __syncwarp();
}

__global__ void __launch_bounds__(32 * (kPlayerWarps + kCopyWarps)) round_kernel(RoundArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = a.M, S = a.S, SM = a.S * a.M;
  const int M4 = (M + 3) & ~3;      // words of a float/int row, 16 B aligned
  const int C4 = (a.C + 3) & ~3;
  const int MB = (M + 15) & ~15;    // bytes of a bool row
  // every lane's rows: lane s's row of each starts s * M4 words (s * MB
  // bytes) in
  float* q_s = reinterpret_cast<float*>(smem);
  float* arr_s = q_s + S * M4;      // this CTA's arrivals this round
  float* s_s = arr_s + S * M4;
  float* srv_s = s_s + S * M4;
  uint8_t* act_s = reinterpret_cast<uint8_t*>(srv_s + S * M4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pthreads = 32 * a.player_warps;

  if (warp >= a.player_warps) {     // a copy warp
    copy_rings(a);
    __syncthreads();                // the players' last round waits here
    return;
  }

  const int wbytes = 24 * M4 + 4 * C4 + 16 + MB;
  unsigned char* wbase = smem + S * (16 * M4 + MB) + warp * wbytes;
  float* wf = reinterpret_cast<float*>(wbase);
  const Row row{wf, wf + M4, wf + 2 * M4, wf + 3 * M4,
                reinterpret_cast<int32_t*>(wf + 4 * M4),
                reinterpret_cast<int32_t*>(wf + 5 * M4), wf + 6 * M4,
                reinterpret_cast<int32_t*>(wf + 6 * M4 + C4),
                wbase + 24 * M4 + 4 * C4 + 16};

  for (int i = threadIdx.x; i < SM; i += pthreads) {
    const int f = (i / M) * M4 + i % M;
    q_s[f] = a.q_in[i];
    arr_s[f] = 0.f;
    s_s[f] = a.s_m[i];
    srv_s[f] = a.served[i];
    act_s[(i / M) * MB + i % M] = a.active[i];
  }
  sync_players(pthreads);

  const int gw = blockIdx.x * a.player_warps + warp;
  const int W = gridDim.x * a.player_warps;
  // A warp with one player keeps it in shared memory and runs only its
  // request before each barrier: the rest of the round and the next
  // round's selection, which read no arrivals of this round, run while
  // the barrier completes. A warp with several players runs each one's
  // whole round before the barrier.
  const bool resident = a.ppw == 1 && gw < a.K;
  const float t_cd = a.t_cd;
  const int gl = resident ? gw / a.Kl : 0;   // the resident player's lane
  Pick pick{0, 0.f};
  if (resident) {
    load_row(a, row, gw, true, lane);
    pick = select(row, M, lane);
  }
  for (int r = 0; r < a.C; ++r) {
    if (resident) {
      request(row, r, pick, arr_s + gl * M4, lane);
    } else {
      for (int k = gw; k < a.K; k += W) {
        const int l = k / a.Kl;
        load_row(a, row, k, r == 0, lane);
        const Pick p = select(row, M, lane);
        finish(a, row, k, r, p, q_s + l * M4, s_s + l * M4, act_s + l * MB,
               lane, t_cd);
        request(row, r, p, arr_s + l * M4, lane);
        store_row(a, row, k, lane);
      }
    }
    if (r == a.C - 1)
      __syncthreads();              // with the copy warps: the rings are copied
    else
      sync_players(pthreads);
    float* ws = a.arr_ws + static_cast<size_t>(r) * SM;
    for (int i = threadIdx.x; i < SM; i += pthreads) {
      const int f = (i / M) * M4 + i % M;
      if (arr_s[f] != 0.f) atomicAdd(ws + i, arr_s[f]);
      arr_s[f] = 0.f;
    }
    sync_players(pthreads);
    grid_arrive(a.bar);
    if (resident) {
      finish(a, row, gw, r, pick, q_s + gl * M4, s_s + gl * M4,
             act_s + gl * MB, lane, t_cd);
      if (r + 1 < a.C)
        pick = select(row, M, lane);
      else
        store_row(a, row, gw, lane);
    }
    grid_wait(a.bar, static_cast<unsigned int>(r + 1) * gridDim.x);
    sync_players(pthreads);
    for (int i = threadIdx.x; i < SM; i += pthreads) {
      const int f = (i / M) * M4 + i % M;
      q_s[f] = fmaxf(__fsub_rn(__fadd_rn(q_s[f], __ldcg(ws + i)), srv_s[f]), 0.f);
    }
    sync_players(pthreads);
  }

  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < SM; i += pthreads) {
      float tot = 0.f;
      for (int r = 0; r < a.C; ++r)
        tot = __fadd_rn(tot, __ldcg(a.arr_ws + static_cast<size_t>(r) * SM + i));
      a.q_out[i] = q_s[(i / M) * M4 + i % M];
      a.arrivals[i] = tot;
    }
  }
  for (int k = gw; k < a.K; k += W) ring_writes(a, row, k, lane);
}

// Above 48 KB a launch needs the kernel's limit raised first.
cudaError_t allow_smem(int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(round_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// CTAs of `threads` threads and `smem` bytes of dynamic shared memory
// that fit on one SM at once, and the SM count, for the current
// device. Returns the cudaError_t of the queries.
extern "C" int round_step_occupancy(int threads, int smem, int* ctas_per_sm,
                                    int* sms) {
  cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, round_kernel,
                                                    threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
}

// Cooperative launch of `grid` CTAs of `player_warps` + kCopyWarps warps
// on `stream`; the inputs are read only, every output is written.
// `workspace` holds 32 + C * S * M zeroed words; K counts the players of
// all S lanes, Kl = K / S a lane. Returns the cudaError_t of the launch.
extern "C" int round_step_launch(
    const float* weights, const float* cw, const int32_t* err,
    const float* cooldown, const uint8_t* in_pool, const uint8_t* active,
    const float* lat_buf, const float* ts_buf, const int32_t* ptr,
    const float* r_buf, const float* rts_buf, const int32_t* rptr,
    const float* q_in, const int32_t* nc, const float* z, const float* rtt,
    const float* s_m, const float* served, float* w_o, float* cw_o,
    int32_t* err_o, float* cd_o, uint8_t* pool_o, float* lat_o, float* ts_o,
    int32_t* ptr_o, float* rb_o, float* rts_o, int32_t* rptr_o, float* q_out,
    float* arrivals, int32_t* choices, float* lats, float* procs,
    float* workspace, int K, int M, int R, int Rq, int C, int S, int Kl,
    int grid,
    int player_warps, int smem, int ppw, float t, float tau, int err_thresh,
    float t_cd, void* stream) {
  RoundArgs a{weights, cw, err, cooldown, in_pool, active, lat_buf, ts_buf,
              ptr, r_buf, rts_buf, rptr, q_in, nc, z, rtt, s_m, served,
              w_o, cw_o, err_o, cd_o, pool_o, lat_o, ts_o, ptr_o, rb_o,
              rts_o, rptr_o, q_out, arrivals, choices, lats, procs,
              reinterpret_cast<unsigned int*>(workspace), workspace + 32,
              K, M, R, Rq, C, S, Kl, player_warps, ppw, t, tau, t_cd,
              err_thresh};
  void* args[] = {&a};
  cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(round_kernel), dim3(grid),
      dim3(32 * (player_warps + kCopyWarps)), args, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
