// Fused Alg-1 maintenance statistics, and the KDE success probability
// alone, with each row held in the registers of the lanes it needs.
//
// maintenance_kernel replaces the TPU kernel
// repro/kernels/kde.py::fused_maintenance (body _maintenance_kernel): per
// row of R windowed latency samples, the masked mean and variance,
// Silverman's bandwidth h = max(1.06 * sigma * n^-0.2, min_bw), the mean
// Gaussian CDF at tau (the KDE success probability mu), and the masked
// rho-quantile of the processing component max(lat - rtt, 0).
//
// kde_kernel replaces the TPU kernel repro/kernels/kde.py::
// kde_success_prob (body _kde_kernel): per row, sum_r mask * Phi((tau -
// lat) / bw) / max(n, 1), or 0 where n = 0, with Phi(z) = (1 + erf(z /
// sqrt 2)) / 2: the middle stage of maintenance_kernel with the
// bandwidths given. Both call cdf_sum below.
//
// What bounds them on the H100: bytes, then latency. maintenance_kernel
// at the simulator's shape (ceil(K/10)*M = 5,000 rows of R = 64) moves
// 1.66 MB, 0.5 us at 3.35 TB/s, so a call is its launch plus one row's
// dependent chain (loads, three row sums, powf, erff, the selection);
// kde_kernel at benchmarks/footprint.py's 65,536 rows of R = 64 moves
// 21.5 MB, 6.4 us, with ~35 instructions of erff and scaling a sample,
// ~5 us of the card's issue rate, so loads and arithmetic must overlap.
//
// The design (PR 11's one warp a row, three passes over the row and an
// R^2 rank count in shared memory, is gone):
// - A row of R samples lives on L lanes of one warp (L a power of two,
//   the fewest that hold it as 4-sample quads; 32 / L rows a warp), each
//   lane holding CH quads: quad c of lane l covers samples c*4L + 4l ..
//   + 3. Where R % 4 == 0 a quad is one 16-byte load of lat and one
//   4-byte load of mask; the ragged tail of any other R is masked. The
//   row's sums are shuffles inside its L lanes.
// - mu is computed op for op as the plain version computes it
//   (ref.bandit_maintenance_stats, which rounds as XLA:CPU does), so the
//   two agree bit for bit: each lane stages its samples' terms in shared
//   memory and the row's sums run in the plain version's order
//   (xla_row_sum: blocks of 32 columns, each left to right, lane b adding
//   block b, then the block sums in order; xla_kde_sum: the KDE's order,
//   which depends on R); n^-0.2 comes from the plain version's table of
//   glibc's powf (CUDA's powf is not glibc's); the root is correctly
//   rounded, every division IEEE; erf is core/fmath.py's rational
//   polynomial, each Horner step rounded through float64 as the plain
//   version rounds it. The serial chains cost latency (a row's three sums
//   are dependent adds) in place of shuffle trees.
// - The quantile sorts the row's 32-bit keys by a bitonic network over
//   its L lanes (in-lane compare-exchanges, then shuffles), with no
//   shared memory and no R^2 count: log2(N)(log2(N)+1)/2 stages for N =
//   4 * L * CH slots, every index into the slot array a constant (the
//   stages are template arguments; an index the compiler cannot fold
//   puts the array in local memory, which costs more than the sort). The
//   key is order-preserving on the float's bits (-0.0 keyed as +0.0, as
//   torch.sort orders them equal; a masked sample keyed as FLT_MAX; a
//   slot past R above every sample). The target rank int(rho * (n - 1))
//   is computed in float32, as the plain version computes it. Equal keys
//   are equal bits but for the two zeros, so the key at that rank is the
//   answer unless it is the zeros' key; then the row takes the zero a
//   sort of (key, index) would, the one of that rank among its zeros in
//   index order (a prefix count over the lanes), and writes its own
//   bits. q is bit-exact against a sort; ties go to the lower index.
// - kde_kernel gives a lane 4 quads of a row at a time (16 samples: four
//   16-byte loads in flight and 16 independent erff; at R = 64 a row on 4
//   lanes, 8 rows a warp), runs a grid of the resident blocks (occupancy
//   x SMs) that strides over (row, segment) items, any R, and issues each
//   item's loads before the erff of the item before it.
// kde_kernel reassociates its sums (lane order, then a shuffle tree) and
// uses CUDA's erff and one reciprocal of the bandwidth a row: within a few
// float32 ULP of its plain version. The library is built with
// --fmad=false so no a*b+c is contracted.
#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInvSqrt2 = 0.7071067811865476f;

// Sum over the L lanes of a row (an aligned group of L lanes).
template <int L, typename T>
__device__ __forceinline__ T row_sum(T v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One quad of a row: samples j .. j + 3, those at or past R zero and
// invalid. Returns the valid bits (bit s: sample j + s in range and
// unmasked).
__device__ __forceinline__ uint32_t load_quad(const float* __restrict__ lrow,
                                              const uint8_t* __restrict__ mrow,
                                              int j, int R, bool vec, float* x) {
  uint32_t valid = 0;
  if (vec) {  // R % 4 == 0 and the rows 16-byte aligned: a quad is all in or all out
    if (j < R) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(lrow + j));
      const uint32_t m = __ldg(reinterpret_cast<const unsigned int*>(mrow + j));
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
#pragma unroll
      for (int s = 0; s < 4; ++s) valid |= ((m >> (8 * s)) & 0xffu) ? 1u << s : 0u;
    } else {
      x[0] = x[1] = x[2] = x[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const bool in = j + s < R;
      x[s] = in ? lrow[j + s] : 0.f;
      valid |= (in && mrow[j + s]) ? 1u << s : 0u;
    }
  }
  return valid;
}

// The KDE middle stage on a lane's V samples: sum of Phi((tau - x) * rh)
// over the valid ones (rh = 1 / h), each term times its mask as the plain
// version takes it.
template <int V>
__device__ __forceinline__ float cdf_sum(const float* x, uint32_t valid, float tau,
                                         float rh) {
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float z = (tau - x[v]) * rh;
    const float cdf = 0.5f * (1.f + erff(z * kInvSqrt2));
    s += cdf * (((valid >> v) & 1u) ? 1.f : 0.f);
  }
  return s;
}

// core/fmath.py::erf's constants: the clamp where x p(x^2) / q(x^2) reaches
// 1.0f, and the two polynomials, highest power first
constexpr float kErfClamp = 3.7439211627767994f;
__constant__ float kErfP[5] = {2.2905065861350646e-4f, 3.4082910107109506e-3f,
                            5.0955695062380861e-2f, 1.8520832239976145e-1f,
                            1.128379143519084f};
__constant__ float kErfQ[7] = {-1.1791602954361697e-7f, 2.3547966471313185e-5f,
                            1.0179625278914885e-3f,  1.4070470171167667e-2f,
                            1.1098505178285362e-1f,  4.9746925110067538e-1f, 1.0f};

// float32 erf rounded as the plain version rounds it (core/fmath.py::erf):
// denormals flushed, x clamped, x^2 in float32, each Horner step p * x2 + c
// added in float64 (the product of two floats is exact there) and stored
// back to float32, then x * p / q.
__device__ __forceinline__ float erf_plain(float x) {
  if (fabsf(x) < FLT_MIN) x = __fmul_rn(0.f, x);
  x = fminf(fmaxf(x, -kErfClamp), kErfClamp);
  const double x2 = static_cast<double>(__fmul_rn(x, x));
  float p = kErfP[0];
#pragma unroll
  for (int i = 1; i < 5; ++i) p = __double2float_rn(__dadd_rn(__dmul_rn(p, x2), kErfP[i]));
  float q = kErfQ[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) q = __double2float_rn(__dadd_rn(__dmul_rn(q, x2), kErfQ[i]));
  return __fdiv_rn(__fmul_rn(x, p), q);
}

// The shared-memory slot of a lane's value v: the sample's index in the row
// (quad c of lane l covers samples c*4L + 4l .. + 3).
template <int L>
__device__ __forceinline__ int slot(int v, int l) {
  return (v / 4) * 4 * L + 4 * l + (v % 4);
}

__device__ __forceinline__ float mask_of(uint32_t valid, int v) {
  return ((valid >> v) & 1u) ? 1.f : 0.f;
}

// The sum of a row's R staged values in ref._xla_row_sum's order: blocks of
// 32 columns (one block of R where R <= 32), each added left to right (the
// last block's columns past R as +0.0), then the block sums in order. Lane b
// of the row adds block b (R <= 4 * L * CH gives at most L blocks); every
// lane returns the total.
__device__ __forceinline__ float xla_row_sum(const float* rbuf, float* rpart, int R,
                                             int l) {
  const int width = R <= 32 ? R : 32;
  const int blocks = (R + width - 1) / width;
  if (l < blocks) {
    float acc = rbuf[l * width];
    for (int j = 1; j < width; ++j) {
      const int c = l * width + j;
      acc = __fadd_rn(acc, c < R ? rbuf[c] : 0.f);
    }
    rpart[l] = acc;
  }
  __syncwarp();
  float total = rpart[0];
  for (int b = 1; b < blocks; ++b) total = __fadd_rn(total, rpart[b]);
  __syncwarp();  // every lane has read the slots and the block sums
  return total;
}

// The KDE's sum of a row's R staged terms in ref._xla_kde_sum's order: that
// of xla_row_sum where R <= 10 or R > 32; between, eight accumulators
// (column j into j % 8, over the first 16 columns zero-padded where R <= 16,
// else over the whole eights), halved three times, then the columns past
// the eights left to right. Every lane adds the row alone (the row's slots
// are not written again after it).
__device__ __forceinline__ float xla_kde_sum(const float* rbuf, float* rpart, int R,
                                             int l) {
  if (R <= 10 || R > 32) return xla_row_sum(rbuf, rpart, R, l);
  const int eights = R <= 16 ? 2 : R / 8;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i] = rbuf[i];
    for (int c = 1; c < eights; ++c) {
      const int j = 8 * c + i;
      acc[i] = __fadd_rn(acc[i], j < R ? rbuf[j] : 0.f);
    }
  }
#pragma unroll
  for (int h = 4; h >= 1; h >>= 1)
#pragma unroll
    for (int i = 0; i < h; ++i) acc[i] = __fadd_rn(acc[i], acc[i + h]);
  float total = acc[0];
  for (int j = 8 * eights; j < R; ++j) total = __fadd_rn(total, rbuf[j]);
  return total;
}

constexpr uint32_t kZeroKey = 0x80000000u;  // the key of +0.0 (and -0.0)

// Order-preserving key of a float's bits; -0.0 keyed as +0.0.
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

// One stage of an ascending bitonic sort of N = L * V slots: slot p =
// l * V + v is a[v] of the row's lane l; the pairs p, p ^ J meet, sorted
// up where p & K is 0. Pairs J >= V apart meet by shuffle (lane l ^ J / V),
// closer ones inside a lane. K and J are template arguments so that every
// index into a[] is a constant and a[] stays in registers.
template <int L, int V, int K, int J>
__device__ __forceinline__ void bitonic_stage(uint32_t* a, int l) {
  if constexpr (J >= V) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int p = l * V + v;
      const uint32_t o = __shfl_xor_sync(kFull, a[v], J / V);
      const bool take_min = ((p & J) == 0) == ((p & K) == 0);
      a[v] = take_min ? (o < a[v] ? o : a[v]) : (o > a[v] ? o : a[v]);
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (v & J) continue;
      const bool up = ((l * V + v) & K) == 0;
      const uint32_t lo = a[v], hi = a[v ^ J];
      const bool swap = up ? lo > hi : lo < hi;
      a[v] = swap ? hi : lo;
      a[v ^ J] = swap ? lo : hi;
    }
  }
}

// The stages from (K, J) on: J halves down to 1, then K doubles up to N.
template <int L, int V, int K = 2, int J = 1>
__device__ __forceinline__ void bitonic_sort(uint32_t* a, int l) {
  bitonic_stage<L, V, K, J>(a, l);
  if constexpr (J > 1)
    bitonic_sort<L, V, K, J / 2>(a, l);
  else if constexpr (2 * K <= L * V)
    bitonic_sort<L, V, 2 * K, K>(a, l);
}

template <int L, int CH>
__global__ void __launch_bounds__(kThreads)
    maintenance_kernel(const float* __restrict__ lat, const uint8_t* __restrict__ mask,
                       const float* __restrict__ rtt, const float* __restrict__ pow_table,
                       float* __restrict__ mu_out, float* __restrict__ q_out, int rows, int R,
                       bool vec, float tau, float rho, float min_bw) {
  constexpr int V = 4 * CH;
  const int lane = threadIdx.x & 31;
  const int l = lane % L;
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / L;
  const bool live = row < rows;  // a dead row's lanes still join the shuffles
  const float* lrow = lat + (live ? row : 0) * static_cast<long long>(R);
  const uint8_t* mrow = mask + (live ? row : 0) * static_cast<long long>(R);

  float x[V];
  uint32_t valid = 0;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const uint32_t b = load_quad(lrow, mrow, live ? c * 4 * L + 4 * l : R, R, vec, x + 4 * c);
    valid |= b << (4 * c);
  }
  const float rtt_row = live ? rtt[row] : 0.f;

  // --- mu, op for op as the plain version: n, the mean and variance, the
  // bandwidth, the KDE, each sum in its order over the row's staged slots ---
  constexpr int kSlots = 4 * L * CH;             // a row's slots
  constexpr int kParts = (kSlots + 31) / 32;     // its blocks of 32 columns
  __shared__ float slots[(kThreads / L) * kSlots];
  __shared__ float parts[(kThreads / L) * kParts];
  float* rbuf = slots + (threadIdx.x / L) * kSlots;
  float* rpart = parts + (threadIdx.x / L) * kParts;
  float n = 0.f;
  __syncwarp();
#pragma unroll
  for (int v = 0; v < V; ++v) {
    n += mask_of(valid, v);  // whole numbers: any order
    rbuf[slot<L>(v, l)] = __fmul_rn(x[v], mask_of(valid, v));
  }
  __syncwarp();
  n = row_sum<L, float>(n);
  const float nc = fmaxf(n, 1.f);
  const float mean = __fdiv_rn(xla_row_sum(rbuf, rpart, R, l), nc);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float d = __fsub_rn(x[v], mean);
    rbuf[slot<L>(v, l)] = __fmul_rn(__fmul_rn(d, d), mask_of(valid, v));
  }
  __syncwarp();
  const float var = __fdiv_rn(xla_row_sum(rbuf, rpart, R, l), nc);
  const float sigma = __fsqrt_rn(fmaxf(var, 0.f));
  const float h =
      fmaxf(__fmul_rn(__fmul_rn(1.06f, sigma), pow_table[static_cast<int>(nc)]), min_bw);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float z = __fdiv_rn(__fsub_rn(tau, x[v]), h);
    const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, erf_plain(__fmul_rn(z, kInvSqrt2))));
    rbuf[slot<L>(v, l)] = __fmul_rn(cdf, mask_of(valid, v));
  }
  __syncwarp();
  // every lane sums (the sums hold __syncwarp), then an empty row takes 0
  const float contrib = xla_kde_sum(rbuf, rpart, R, l);
  const float mu = n > 0.f ? __fdiv_rn(contrib, nc) : 0.f;

  // --- the masked rho-quantile: sort the keys, take rank tgt ---
  uint32_t a[V];
  uint32_t zero = 0, negz = 0;  // slots of valid samples whose processing value is +-0.0, -0.0
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int idx = (v / 4) * 4 * L + 4 * l + (v % 4);
    a[v] = 0xffffffffu;  // past R: after every sample
    if (idx < R) {
      const float d = x[v] - rtt_row;
      const float p = d < 0.f ? 0.f : d;  // max(d, 0), -0.0 kept as torch keeps it
      const bool ok = (valid >> v) & 1u;
      zero |= (ok && p == 0.f) ? 1u << v : 0u;
      negz |= (ok && __float_as_uint(p) == 0x80000000u) ? 1u << v : 0u;
      a[v] = order_key(ok ? p : FLT_MAX);
    }
  }
  bitonic_sort<L, V>(a, l);
  const int tgt = min(max(static_cast<int>(rho * (n - 1.f)), 0), R - 1);
  uint32_t mine = 0;  // a[tgt % V] by masks: an indexed read would put a[] in local memory
#pragma unroll
  for (int v = 0; v < V; ++v) mine |= a[v] & (v == tgt % V ? ~0u : 0u);
  const uint32_t key = __shfl_sync(kFull, mine, lane - l + tgt / V);

  // Equal keys are equal bits but for the two zeros. Where the rank falls
  // on them (in some row of the warp: the branch is uniform, the shuffles
  // need every lane), take the zero a sort of (key, index) takes: the
  // (tgt - below)th of the row's zeros in index order (chunk, lane, slot).
  bool owner = false, neg = false;
  if (__any_sync(kFull, key == kZeroKey)) {
    int below = 0;
#pragma unroll
    for (int v = 0; v < V; ++v) below += a[v] < kZeroKey;
    int rank = tgt - row_sum<L, int>(below);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const uint32_t nib = (zero >> (4 * c)) & 0xfu;
      const int here = __popc(nib);
      int incl = here;  // zeros of this chunk up to this lane
#pragma unroll
      for (int d = 1; d < L; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d, L);
        incl += l >= d ? up : 0;
      }
      const int k = rank - (incl - here);
      if (k >= 0 && k < here) {
        int s = 0;  // the k-th set bit of nib
#pragma unroll
        for (int b = 0, seen = 0; b < 4; ++b) {
          if (((nib >> b) & 1u) && seen++ == k) s = b;
        }
        owner = true;
        neg = (negz >> (4 * c + s)) & 1u;
      }
      rank -= __shfl_sync(kFull, incl, L - 1, L);
    }
  }
  const bool on_zero = key == kZeroKey;
  if (live && (on_zero ? owner : l == 0)) {
    mu_out[row] = mu;
    q_out[row] = on_zero ? (neg ? -0.f : 0.f) : from_key(key);
  }
}

// One (row, segment) item of kde_kernel: CH quads of each of the warp's
// 32 / L rows (quad c of lane l at c * 4L + 4l in the segment), and the
// row's bandwidth.
template <int CH>
struct KdeItem {
  float x[4 * CH];
  uint32_t valid;
  float h;
};

template <int L, int CH>
__device__ __forceinline__ KdeItem<CH> kde_load(const float* __restrict__ lat,
                                                const uint8_t* __restrict__ mask,
                                                const float* __restrict__ bw, long long row,
                                                int seg, int rows, int R, bool vec, int l) {
  KdeItem<CH> it;
  const bool live = row < rows;
  const long long r = live ? row : 0;
  it.valid = 0;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int j = live ? (seg * CH + c) * 4 * L + 4 * l : R;
    it.valid |= load_quad(lat + r * R, mask + r * R, j, R, vec, it.x + 4 * c) << (4 * c);
  }
  it.h = live ? bw[r] : 1.f;
  return it;
}

template <int L, int CH>
__global__ void __launch_bounds__(kThreads)
    kde_kernel(const float* __restrict__ lat, const uint8_t* __restrict__ mask,
               const float* __restrict__ bw, float* __restrict__ out, int rows, int R,
               bool vec, float tau) {
  constexpr int G = 32 / L;  // rows a warp
  const int lane = threadIdx.x & 31;
  const int l = lane % L;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  const long long groups = (rows + G - 1) / G;
  const int nseg = (R + 4 * L * CH - 1) / (4 * L * CH);

  long long g = warp;  // uniform across the warp, as are seg and the loop
  int seg = 0;
  KdeItem<CH> cur{};
  if (g < groups) cur = kde_load<L, CH>(lat, mask, bw, g * G + lane / L, seg, rows, R, vec, l);
  float n = 0.f, s = 0.f;
  while (g < groups) {
    long long g2 = g;
    int seg2 = seg + 1;
    if (seg2 == nseg) seg2 = 0, g2 += warps;
    KdeItem<CH> nxt{};
    if (g2 < groups)
      nxt = kde_load<L, CH>(lat, mask, bw, g2 * G + lane / L, seg2, rows, R, vec, l);
    n += static_cast<float>(__popc(cur.valid));
    s += cdf_sum<4 * CH>(cur.x, cur.valid, tau, __frcp_rn(cur.h));
    if (seg == nseg - 1) {
      n = row_sum<L, float>(n);
      s = row_sum<L, float>(s);
      const long long row = g * G + lane / L;
      if (l == 0 && row < rows) out[row] = n > 0.f ? s / fmaxf(n, 1.f) : 0.f;
      n = s = 0.f;
    }
    cur = nxt;
    g = g2;
    seg = seg2;
  }
}

template <int L, int CH>
int launch_maintenance(const float* lat, const uint8_t* mask, const float* rtt,
                       const float* pow_table, float* mu, float* q, int rows, int R, bool vec,
                       float tau, float rho, float min_bw, cudaStream_t stream) {
  const long long blocks = (static_cast<long long>(rows) * L + kThreads - 1) / kThreads;
  maintenance_kernel<L, CH><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      lat, mask, rtt, pow_table, mu, q, rows, R, vec, tau, rho, min_bw);
  return static_cast<int>(cudaGetLastError());
}

template <int L, int CH>
int launch_kde(const float* lat, const uint8_t* mask, const float* bw, float* out, int rows,
               int R, bool vec, float tau, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kde_kernel<L, CH>, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long groups = (rows + 32 / L - 1) / (32 / L);
  const long long needed = (groups + kThreads / 32 - 1) / (kThreads / 32);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long blocks = needed < resident ? needed : resident;
  kde_kernel<L, CH><<<static_cast<unsigned>(blocks > 0 ? blocks : 1), kThreads, 0, stream>>>(
      lat, mask, bw, out, rows, R, vec, tau);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lat (rows, R) float32, mask (rows, R) bool bytes, rtt (rows,), pow_table
// (R + 1,) float32 with n^-0.2 at n (glibc's powf, ref._powf_table); mu and q
// (rows,). A row on `lanes` lanes (1, 2, ..., 32) of `chunks` quads each
// (1 below 32 lanes; 1, 2, 4 or 8 at 32), as kde.row_geometry gives them;
// `vec`: R % 4 == 0 and lat 16-byte, mask 4-byte aligned.
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int maintenance_launch(const float* lat, const uint8_t* mask, const float* rtt,
                                  const float* pow_table, float* mu, float* q, int rows,
                                  int R, int lanes,
                                  int chunks, int vec, float tau, float rho, float min_bw,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  using Launch = int (*)(const float*, const uint8_t*, const float*, const float*, float*,
                         float*, int, int, bool, float, float, float, cudaStream_t);
  Launch fn = nullptr;
  if (chunks == 1) {
    switch (lanes) {
      case 1: fn = launch_maintenance<1, 1>; break;
      case 2: fn = launch_maintenance<2, 1>; break;
      case 4: fn = launch_maintenance<4, 1>; break;
      case 8: fn = launch_maintenance<8, 1>; break;
      case 16: fn = launch_maintenance<16, 1>; break;
      case 32: fn = launch_maintenance<32, 1>; break;
    }
  } else if (lanes == 32) {
    switch (chunks) {
      case 2: fn = launch_maintenance<32, 2>; break;
      case 4: fn = launch_maintenance<32, 4>; break;
      case 8: fn = launch_maintenance<32, 8>; break;
    }
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(lat, mask, rtt, pow_table, mu, q, rows, R, v, tau, rho, min_bw, st);
}

// lat (rows, R) float32, mask (rows, R) bool bytes, bw and out (rows,); any
// R >= 1, a row on `lanes` lanes of `chunks` quads, in segments of 4 *
// lanes * chunks samples, as kde.kde_geometry gives them (1, 2 or 4 quads
// on one lane; 4 quads on 2 to 32 lanes); `vec` as above.
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int kde_launch(const float* lat, const uint8_t* mask, const float* bw, float* out,
                          int rows, int R, int lanes, int chunks, int vec, float tau,
                          void* stream) {
  using Launch = int (*)(const float*, const uint8_t*, const float*, float*, int, int, bool,
                         float, cudaStream_t);
  Launch fn = nullptr;
  if (lanes == 1) {
    fn = chunks == 1 ? launch_kde<1, 1> : chunks == 2 ? launch_kde<1, 2> : nullptr;
    fn = chunks == 4 ? launch_kde<1, 4> : fn;
  } else if (chunks == 4) {
    switch (lanes) {
      case 2: fn = launch_kde<2, 4>; break;
      case 4: fn = launch_kde<4, 4>; break;
      case 8: fn = launch_kde<8, 4>; break;
      case 16: fn = launch_kde<16, 4>; break;
      case 32: fn = launch_kde<32, 4>; break;
    }
  }
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(lat, mask, bw, out, rows, R, vec != 0, tau, static_cast<cudaStream_t>(stream));
}
