// Fused Alg-1 maintenance statistics, one warp per (player, arm) row.
//
// Replaces the TPU kernel repro/kernels/kde.py::fused_maintenance (body
// _maintenance_kernel): per row of R windowed latency samples, the
// masked mean and variance, Silverman's bandwidth
// h = max(1.06 * sigma * n^-0.2, min_bw), the mean Gaussian CDF at tau
// (the KDE success probability mu), and the masked rho-quantile of the
// processing component max(lat - rtt, 0) by stable rank selection.
//
// What bounds it on the H100: bytes. Each row reads R floats of latency
// and R mask bytes once and writes two floats; the rank selection is
// R*R compares per row held in shared memory, ~2.5 compares per input
// byte, far below the card's 67 TFLOP/s float32 rate against its
// 3.35 TB/s. At the simulator's shape (ceil(K/10)*M = 5,000 rows of
// R = 64) the whole call moves ~1.7 MB, so launch latency dominates.
//
// Design: one warp per row, lanes stride the R samples (2 each at
// R = 64; any R up to 1024 by the same masked loop). Three
// shuffle-reduced passes give n, the mean, the variance and the erf
// sum; the row's processing values go to shared memory and every lane
// ranks its own values against all R with the stable-sort order
// before = x_j < x_i || (x_j == x_i && j < i); the one lane whose rank
// equals the target writes q. The quantile selects a sample and does
// no arithmetic, so q is bit-exact against a sort; the target index
// int(rho * (n - 1)) is computed in float32, as the reference computes
// it. mu reassociates the sums (warp tree) and uses CUDA's erff and
// powf, so it matches the plain version to a few float32 ULP. The
// library is built with --fmad=false so no a*b+c is contracted.
#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kInvSqrt2 = 0.7071067811865476f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void maintenance_kernel(const float* __restrict__ lat,
                                   const uint8_t* __restrict__ mask,
                                   const float* __restrict__ rtt,
                                   float* __restrict__ mu_out,
                                   float* __restrict__ q_out, int rows, int R,
                                   float tau, float rho, float min_bw) {
  extern __shared__ float proc_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;  // uniform across the warp
  float* proc = proc_smem + warp * R;
  const float* lrow = lat + static_cast<size_t>(row) * R;
  const uint8_t* mrow = mask + static_cast<size_t>(row) * R;
  const float rtt_row = rtt[row];

  // --- n, sum(lat * m); the processing row goes to shared memory ---
  float n = 0.f, s1 = 0.f;
  for (int j = lane; j < R; j += 32) {
    const float m = mrow[j] ? 1.f : 0.f;
    const float x = lrow[j];
    n += m;
    s1 += x * m;
    proc[j] = mrow[j] ? fmaxf(x - rtt_row, 0.f) : FLT_MAX;
  }
  n = warp_sum(n);
  s1 = warp_sum(s1);
  const float nc = fmaxf(n, 1.f);
  const float mean = s1 / nc;

  // --- Silverman bandwidth h = 1.06 * sigma * n^(-1/5) ---
  float s2 = 0.f;
  for (int j = lane; j < R; j += 32) {
    const float d = lrow[j] - mean;
    s2 += d * d * (mrow[j] ? 1.f : 0.f);
  }
  s2 = warp_sum(s2);
  const float sigma = sqrtf(fmaxf(s2 / nc, 0.f));
  const float h = fmaxf(1.06f * sigma * powf(nc, -0.2f), min_bw);

  // --- Gaussian-CDF success probability at tau ---
  float s3 = 0.f;
  for (int j = lane; j < R; j += 32) {
    const float z = (tau - lrow[j]) / h;
    const float cdf = 0.5f * (1.f + erff(z * kInvSqrt2));
    s3 += cdf * (mrow[j] ? 1.f : 0.f);
  }
  s3 = warp_sum(s3);
  if (lane == 0) mu_out[row] = n > 0.f ? s3 / nc : 0.f;

  // --- masked rho-quantile by stable rank selection ---
  __syncwarp();
  const int tgt = min(max(static_cast<int>(rho * (n - 1.f)), 0), R - 1);
  for (int i = lane; i < R; i += 32) {
    const float xi = proc[i];
    int rank = 0;
    for (int j = 0; j < R; ++j) {
      const float xj = proc[j];
      rank += (xj < xi) || (xj == xi && j < i);
    }
    if (rank == tgt) q_out[row] = n > 0.f ? xi : FLT_MAX;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch.
extern "C" int maintenance_launch(const float* lat, const uint8_t* mask,
                                  const float* rtt, float* mu, float* q,
                                  int rows, int R, float tau, float rho,
                                  float min_bw, void* stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * R * sizeof(float);
  maintenance_kernel<<<blocks, kWarpsPerBlock * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      lat, mask, rtt, mu, q, rows, R, tau, rho, min_bw);
  return static_cast<int>(cudaGetLastError());
}
