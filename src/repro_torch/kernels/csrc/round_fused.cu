// One simulator step's C SWRR request rounds, fused: one CTA per simulation.
//
// Replaces the TPU kernel repro/kernels/round_fused.py::round_step_swrr
// (body _round_kernel). Per round r and player k: SWRR selection on the
// (M,) credits, latency rtt + (q + 1) * s_m * z on the shared queue,
// the consecutive-error counter with its cooldown trip, pool and weight
// renormalisation, one latency-ring and one reward-ring write; between
// rounds the round's arrivals land on the shared (M,) queue, which
// drains served_per_round before the next round reads it.
//
// What bounds it on the H100: neither bytes nor operations but the
// round-to-round dependency. The function moves the (K, M) state and
// the rings (~62 MB in and out at K = 1000, M = 50, R = 64, Rq = 512,
// ~19 us at 3.35 TB/s) and does O(C * K * M) work, yet every round
// reads the queue every player's previous round filled. The TPU kernel
// leans on two TPU behaviours for that: grid steps run in order, and a
// revisited output block keeps its contents. Hopper blocks do neither.
//
// Design, the simple one that is right: one CTA runs the whole step.
// One thread per player (threads stride over K beyond 1024); the C
// rounds loop inside the kernel; the queue and the round's arrivals sit
// in shared memory. Between rounds: __syncthreads, each issued request
// is atomicAdd-ed into the arrivals (integer-valued float32, so the
// order does not matter below 2^24), __syncthreads, M threads drain the
// queue, __syncthreads. A player's (M,) rows of weights, credits,
// counters, cooldowns and pool bits are private to its thread and are
// updated in place in device memory, served by L1. Ring writes follow
// the sequential core.bandit.record semantics, one slot per player per
// round. This fills one SM of 132; a grid-wide barrier or thread block
// clusters would spread it (a later change).
//
// Exactness against the plain version: the argmax scans arms in
// ascending order with a strict > (first maximal index, as jnp.argmax);
// the two row sums (SWRR total, renormalising wsum) add the M columns
// left to right, as the plain version does; the latency chain and
// t + cooldown use explicit round-to-nearest intrinsics, and the
// library is built with --fmad=false, so no a*b+c becomes an FMA except
// the one the reference has: lat = fma((q + 1) * s, z, rtt), which
// XLA:CPU contracts and the plain version rounds once as well.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

struct RoundArgs {
  float* weights;       // (K, M)   in place
  float* cw;            // (K, M)   in place
  int32_t* err;         // (K, M)   in place
  float* cooldown;      // (K, M)   in place
  uint8_t* in_pool;     // (K, M)   in place (bool)
  const uint8_t* active;  // (M,)   bool
  float* lat_buf;       // (K, M, R) in place
  float* ts_buf;        // (K, M, R) in place
  int32_t* ptr;         // (K, M)   in place
  float* r_buf;         // (K, Rq)  in place
  float* rts_buf;       // (K, Rq)  in place
  int32_t* rptr;        // (K,)     in place
  const float* q_in;    // (M,)
  float* q_out;         // (M,)
  float* arrivals;      // (M,)
  const int32_t* nc;    // (K,)
  const float* z;       // (C, K)
  const float* rtt;     // (K, M)
  const float* s_m;     // (M,)
  const float* served;  // (M,)
  int32_t* choices;     // (K, C)
  float* lats;          // (K, C)
  float* procs;         // (K, C)
  int K, M, R, Rq, C;
  float t, tau, cooldown_s;
  int err_thresh;
};

__device__ void player_round(const RoundArgs& a, int k, int r, const float* q_s,
                             float* arr_s, float t_cd) {
  const int M = a.M;
  float* w = a.weights + static_cast<size_t>(k) * M;
  float* cw = a.cw + static_cast<size_t>(k) * M;
  int32_t* err = a.err + static_cast<size_t>(k) * M;
  float* cd = a.cooldown + static_cast<size_t>(k) * M;
  uint8_t* pool = a.in_pool + static_cast<size_t>(k) * M;
  int32_t* ptr = a.ptr + static_cast<size_t>(k) * M;
  const bool mask = r < a.nc[k];

  // --- SWRR selection (core.swrr.swrr_select) ---
  float total = 0.f;
  for (int m = 0; m < M; ++m) total = __fadd_rn(total, w[m]);
  int choice = 0;
  float best = 0.f;
  for (int m = 0; m < M; ++m) {
    const float c = __fadd_rn(cw[m], w[m]);
    cw[m] = c;
    if (m == 0 || c > best) {
      best = c;
      choice = m;
    }
  }
  cw[choice] = __fsub_rn(cw[choice], total);

  // --- latency on the shared queue: rtt + ((q + 1) * s) * z, the sum
  // fused with the product into one rounding, as the reference's
  // compiler emits it ---
  const float q1s = __fmul_rn(__fadd_rn(q_s[choice], 1.f), a.s_m[choice]);
  const float z = a.z[static_cast<size_t>(r) * a.K + k];
  const float proc = __fmul_rn(q1s, z);
  const float lat = __fmaf_rn(q1s, z, a.rtt[static_cast<size_t>(k) * M + choice]);

  // --- feedback control (core.bandit._record_control) ---
  const bool reward = lat <= a.tau;
  const int old_err = err[choice];
  const int new_err = reward ? 0 : old_err + 1;
  const bool trip = mask && new_err >= a.err_thresh;
  err[choice] = mask ? (trip ? 0 : new_err) : old_err;
  if (trip) {
    cd[choice] = t_cd;
    pool[choice] = 0;
  }
  float wsum = 0.f;
  bool rem_any = false;
  for (int m = 0; m < M; ++m) {
    const float w2 = (trip && m == choice) ? 0.f : w[m];
    wsum = __fadd_rn(wsum, w2);
    rem_any = rem_any || (pool[m] && a.active[m]);
  }
  float fsum = 0.f;
  for (int m = 0; m < M; ++m) {
    const bool tripped = trip && m == choice;
    fsum += (rem_any ? (pool[m] && a.active[m]) : (a.active[m] && !tripped)) ? 1.f : 0.f;
  }
  const float fden = fmaxf(fsum, 1.f);
  const float wden = fmaxf(wsum, 1e-30f);
  for (int m = 0; m < M; ++m) {
    const bool tripped = trip && m == choice;
    const float w2 = tripped ? 0.f : w[m];
    const bool fb = rem_any ? (pool[m] && a.active[m]) : (a.active[m] && !tripped);
    w[m] = wsum > 0.f ? __fdiv_rn(w2, wden) : __fdiv_rn(fb ? 1.f : 0.f, fden);
  }
  if (trip) cw[choice] = 0.f;

  // --- ring writes, sequential core.bandit.record semantics ---
  if (mask) {
    const int p = ptr[choice];
    const size_t slot = (static_cast<size_t>(k) * M + choice) * a.R + p;
    a.lat_buf[slot] = lat;
    a.ts_buf[slot] = a.t;
    ptr[choice] = (p + 1) % a.R;
    const int rp = a.rptr[k];
    a.r_buf[static_cast<size_t>(k) * a.Rq + rp] = reward ? 1.f : 0.f;
    a.rts_buf[static_cast<size_t>(k) * a.Rq + rp] = a.t;
    a.rptr[k] = (rp + 1) % a.Rq;
    atomicAdd(&arr_s[choice], 1.f);
  }

  // --- per-request outputs ---
  const size_t out = static_cast<size_t>(k) * a.C + r;
  a.choices[out] = choice;
  a.lats[out] = lat;
  a.procs[out] = proc;
}

__global__ void round_kernel(RoundArgs a) {
  extern __shared__ float shared[];
  float* q_s = shared;             // queue
  float* arr_s = shared + a.M;     // this round's arrivals
  float* tot_s = shared + 2 * a.M; // arrivals over all rounds
  for (int m = threadIdx.x; m < a.M; m += blockDim.x) {
    q_s[m] = a.q_in[m];
    arr_s[m] = 0.f;
    tot_s[m] = 0.f;
  }
  __syncthreads();
  const float t_cd = __fadd_rn(a.t, a.cooldown_s);
  for (int r = 0; r < a.C; ++r) {
    for (int k = threadIdx.x; k < a.K; k += blockDim.x) player_round(a, k, r, q_s, arr_s, t_cd);
    __syncthreads();
    for (int m = threadIdx.x; m < a.M; m += blockDim.x) {
      q_s[m] = fmaxf(__fsub_rn(__fadd_rn(q_s[m], arr_s[m]), a.served[m]), 0.f);
      tot_s[m] += arr_s[m];
      arr_s[m] = 0.f;
    }
    __syncthreads();
  }
  for (int m = threadIdx.x; m < a.M; m += blockDim.x) {
    a.q_out[m] = q_s[m];
    a.arrivals[m] = tot_s[m];
  }
}

}  // namespace

// Launch on `stream`; the state arrays are updated in place. Returns the
// cudaError_t of the launch.
extern "C" int round_step_launch(
    float* weights, float* cw, int32_t* err, float* cooldown, uint8_t* in_pool,
    const uint8_t* active, float* lat_buf, float* ts_buf, int32_t* ptr,
    float* r_buf, float* rts_buf, int32_t* rptr, const float* q_in, float* q_out,
    float* arrivals, const int32_t* nc, const float* z, const float* rtt,
    const float* s_m, const float* served, int32_t* choices, float* lats,
    float* procs, int K, int M, int R, int Rq, int C, float t, float tau,
    int err_thresh, float cooldown_s, void* stream) {
  RoundArgs a{weights, cw, err, cooldown, in_pool, active, lat_buf, ts_buf,
              ptr, r_buf, rts_buf, rptr, q_in, q_out, arrivals, nc, z, rtt,
              s_m, served, choices, lats, procs, K, M, R, Rq, C, t, tau,
              cooldown_s, err_thresh};
  int threads = ((K + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t smem = 3 * static_cast<size_t>(M) * sizeof(float);
  round_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
