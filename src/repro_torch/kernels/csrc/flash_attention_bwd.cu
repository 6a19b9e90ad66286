// Backward of the causal GQA prefill attention (flash_attention.cu): dQ, dK
// and dV of O = softmax(mask(q . k^T * scale)) . v, float32 inside, for
// bfloat16 and float32 inputs. Two routes, chosen by the wrapper: bfloat16
// at D 64 and 128 runs on the tensor cores (wgmma, TMA); float32, and
// bfloat16 at D 16, 32 and 256, on the CUDA cores.
//
// Replaces no TPU kernel. The JAX package has no backward kernel: off the TPU
// its training differentiates the plain ref.attention. On the card the
// forward is a kernel whose output carries no autograd graph, so training
// needs the gradient as a kernel too (kernels/ops.py's autograd Function
// calls it); the plain version is ref.attention_grads.
//
// The math, per query head h of batch row b against kv head h / (Hq / Hkv),
// with the forward's mask (cols < S, cols <= rows if causal, rows - cols <
// window if a window): s = scale q . k^T, P = exp(s - lse) (lse the row's
// log-sum-exp), dP = dO . v^T, delta = rowsum(P * dP), dS = P * (dP -
// delta); dV = P^T dO, dQ = scale dS . k, dK = scale dS^T . q. delta is
// taken from P and dP (not from the forward's output, which in bfloat16 is
// rounded), so the gradient is the float32 gradient of the inputs as given.
//
// What bounds it on the H100: operations. At the training shape (B 8, 32/8
// heads, S 256, D 128, causal) the five products of the backward are 1.1e10
// FLOP against 34 MB of q, k, v, dO and gradients, ~320 FLOP per byte,
// above the bf16 tensor-core ridge (~295).
//
// Both routes are two kernels with no atomics, so every gradient element is
// written by one thread in one fixed order and two runs give the same bits:
// a dQ kernel per (b, h, q block) that first walks its kv tiles for each
// row's lse and delta (an online softmax that also carries the sum of exp *
// dP), writes them for the second kernel and walks the tiles again for dQ;
// and a dK/dV kernel per (b, kv head, kv block) that walks the G query heads
// of its group and the q tiles that see its rows (the causal diagonal and
// the window bound the range), so the group's sum happens inside the CTA.
//
// bfloat16, D 64 and 128: flash_bwd_dq_tc_kernel and
// flash_bwd_dkdv_tc_kernel, the forward's flash_tc_kernel turned around.
// - Loads. Thread 0 loads with TMA (cp.async.bulk.tensor, 3-D maps (D, S,
//   B*H), rows swizzled by 128 bytes, so rows past S arrive as zeros): the
//   dQ kernel its 128-row q and dO blocks once and the 64-row K and V tiles
//   of both passes through a 2-stage ring with full/empty mbarriers; the
//   dK/dV kernel its 64-row K and V block once and each (head, q tile)'s q
//   and dO tiles, with the tile's lse and delta (a 1-D bulk copy from rows
//   padded to a multiple of 64), through the ring. Tile i + 1 is in flight
//   while tile i is multiplied; once every warp has released tile i's
//   stage, thread 0 loads tile i + 2 into it. There is no producer warp, as
//   the forward has: a ninth warp puts three warps on one of the SM's four
//   register-file quarters, which caps a thread at 168 registers, and the
//   dQ kernel needs ~220 (at 168 it spills, and setmaxnreg does not lift
//   ptxas's cap). The dK/dV kernel, one warpgroup, fits two CTAs an SM.
// - Products. Every product is wgmma with float32 accumulators. S = q . K^T
//   and dP = dO . V^T (dQ kernel; two warpgroups of 64 q rows), and S^T =
//   K . q^T and dP^T = V . dO^T (dK/dV kernel; one warpgroup of 64 kv
//   rows) take both operands from shared memory. P and dS (P^T
//   and dS^T) are formed in registers, and their accumulator fragments
//   are the A operand of the next products, dQ += dS . K, dV += P^T dO and
//   dK += dS^T q, whose B operand is the (rows, D) tile read MN-major. P
//   and dS enter as two bf16 terms each (hi = x rounded, lo = (x - hi)
//   rounded): one term moves dQ, dK and dV by several times chip_smoke.py's
//   allowance (tests/test_torch_flash_bwd.py models it), two carry ~16 bits.
//   The exponentials are ex2.approx on logits scaled by scale * log2(e);
//   lse is kept in base 2.
// - Skips. Tiles wholly above the causal diagonal or outside the window are
//   skipped; only tiles that cross the diagonal, the window's edge or S are
//   masked element by element.
// - Not yet: D 256 (dK and dV of 64 rows would hold 256 float32 registers a
//   thread), D 80 (its 160-byte rows fit no 128-byte swizzle: five 32-byte
//   boxes, as the forward takes them), overlap of one tile's softmax with the next tile's products,
//   one pass for dQ (lse and delta from the forward), and reading a strided
//   dO where it lies (the wrapper makes it contiguous).
//
// CUDA cores: flash_bwd_dq_kernel and flash_bwd_dkdv_kernel, explicit fmaf
// in float32. Tiles sit in shared memory as float32 (bfloat16 inputs
// widened exactly), rows padded by one word so that no two threads of a
// half-warp hit one bank. 256 threads as 16 x 16: thread (ty, tx) owns rows
// ty + 16 i of a tile and columns tx + 16 j (a kB x kB product) or tx + 16 e
// (a D-wide one), so a row's reductions are shuffles within its half-warp.
// kB is 64, 32 at D = 256 (shared memory); lse is in base e.
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// CUDA cores: float32, and bfloat16 at D 16, 32, 80 and 256.
// ---------------------------------------------------------------------------

namespace cc {

constexpr int kThreads = 256;

template <int D>
struct Tile {
  static constexpr int kB = D == 256 ? 32 : 64;  // rows of a q or kv tile
  static constexpr int kLD = D + 1;              // padded row of a D-wide tile
  static constexpr int kLP = kB + 1;             // padded row of a kB x kB tile
  static constexpr int kR = kB / 16;             // tile rows a thread owns
  static constexpr int kE = D / 16;              // D columns a thread owns
  static constexpr size_t kWide = static_cast<size_t>(kB) * kLD;
  static constexpr size_t kSquare = static_cast<size_t>(kB) * kLP;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool live(int row, int col, int S, int causal, int window) {
  return row < S && col < S && (!causal || col <= row) && (window <= 0 || row - col < window);
}

// rows [row0, row0 + kB) of a (S, D) head into dst (kB x kLD floats); rows at
// or past S are zero
template <typename T, int D>
__device__ void load_rows(float* dst, const T* __restrict__ src, int row0, int S) {
  using C = Tile<D>;
  for (int i = threadIdx.x; i < C::kB * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    dst[r * C::kLD + c] =
        row0 + r < S ? widen(src[static_cast<size_t>(row0 + r) * D + c]) : 0.f;
  }
}

// out[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d] over two D-wide tiles
template <int D>
__device__ __forceinline__ void dot_rows(const float* A, const float* B,
                                         float (&out)[Tile<D>::kR][Tile<D>::kR], int ty,
                                         int tx) {
  using C = Tile<D>;
#pragma unroll
  for (int i = 0; i < C::kR; ++i)
#pragma unroll
    for (int j = 0; j < C::kR; ++j) out[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[C::kR], b[C::kR];
#pragma unroll
    for (int i = 0; i < C::kR; ++i) a[i] = A[(ty + 16 * i) * C::kLD + d];
#pragma unroll
    for (int j = 0; j < C::kR; ++j) b[j] = B[(tx + 16 * j) * C::kLD + d];
#pragma unroll
    for (int i = 0; i < C::kR; ++i)
#pragma unroll
      for (int j = 0; j < C::kR; ++j) out[i][j] = fmaf(a[i], b[j], out[i][j]);
  }
}

// acc[i][e] += sum_c P[ty + 16i][c] * X[c][tx + 16e]   (P a kB x kB tile)
template <int D>
__device__ __forceinline__ void acc_rows(const float* P, const float* X,
                                         float (&acc)[Tile<D>::kR][Tile<D>::kE], int ty,
                                         int tx) {
  using C = Tile<D>;
#pragma unroll 4
  for (int c = 0; c < C::kB; ++c) {
    float p[C::kR];
#pragma unroll
    for (int i = 0; i < C::kR; ++i) p[i] = P[(ty + 16 * i) * C::kLP + c];
#pragma unroll
    for (int e = 0; e < C::kE; ++e) {
      const float x = X[c * C::kLD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < C::kR; ++i) acc[i][e] = fmaf(p[i], x, acc[i][e]);
    }
  }
}

// acc[i][e] += sum_r P[r][ty + 16i] * X[r][tx + 16e]   (P^T times X)
template <int D>
__device__ __forceinline__ void acc_cols(const float* P, const float* X,
                                         float (&acc)[Tile<D>::kR][Tile<D>::kE], int ty,
                                         int tx) {
  using C = Tile<D>;
#pragma unroll 4
  for (int r = 0; r < C::kB; ++r) {
    float p[C::kR];
#pragma unroll
    for (int i = 0; i < C::kR; ++i) p[i] = P[r * C::kLP + ty + 16 * i];
#pragma unroll
    for (int e = 0; e < C::kE; ++e) {
      const float x = X[r * C::kLD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < C::kR; ++i) acc[i][e] = fmaf(p[i], x, acc[i][e]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout, T* __restrict__ dq,
                    float* __restrict__ lse_out, float* __restrict__ delta_out, int Hq,
                    int Hkv, int S, float scale, int causal, int window) {
  using C = Tile<D>;
  constexpr int kB = C::kB, kR = C::kR, kE = C::kE;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + C::kWide;
  float* Ks = dOs + C::kWide;
  float* Vs = Ks + C::kWide;
  float* dSs = Vs + C::kWide;  // kB x kLP

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // long causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = static_cast<size_t>(S) * D;
  const size_t qhead = static_cast<size_t>(b) * Hq + h;
  const size_t kvhead = static_cast<size_t>(b) * Hkv + h / (Hq / Hkv);
  const T* kp = k + kvhead * head;
  const T* vp = v + kvhead * head;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_rows<T, D>(Qs, q + qhead * head, q0, S);
  load_rows<T, D>(dOs, dout + qhead * head, q0, S);

  // kv tiles that hold a live column for some row of this block
  int k_begin = 0;
  int k_end = S;
  if (causal) k_end = min(S, q0 + kB);
  if (window > 0) k_begin = (max(0, q0 - window + 1) / kB) * kB;

  float s[kR][kR], dp[kR][kR];
  float m[kR], l[kR], t[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) m[i] = kNeg, l[i] = 0.f, t[i] = 0.f;

  // pass 1: each row's max, sum of exp and sum of exp * dP, online
  for (int k0 = k_begin; k0 < k_end; k0 += kB) {
    __syncthreads();
    load_rows<T, D>(Ks, kp, k0, S);
    load_rows<T, D>(Vs, vp, k0, S);
    __syncthreads();
    dot_rows<D>(Qs, Ks, s, ty, tx);
    dot_rows<D>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[kR];
      float mt = kNeg;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        ok[j] = live(row, k0 + tx + 16 * j, S, causal, window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      float ps = 0.f, pt = 0.f;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const float e = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps += e;
        pt = fmaf(e, dp[i][j], pt);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = fmaf(l[i], alpha, half_warp_sum(ps));
      t[i] = fmaf(t[i], alpha, half_warp_sum(pt));
      m[i] = m_new;
    }
  }

  float lse[kR], delta[kR];
  const size_t rows = qhead * S;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool in = row < S && l[i] > 0.f;
    lse[i] = in ? m[i] + logf(l[i]) : 0.f;
    delta[i] = in ? t[i] / l[i] : 0.f;
    if (tx == 0 && row < S) {
      lse_out[rows + row] = lse[i];
      delta_out[rows + row] = delta[i];
    }
  }

  // pass 2: dS = P * (dP - delta), dQ += dS . k
  float acc[kR][kE];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[i][e] = 0.f;
  for (int k0 = k_begin; k0 < k_end; k0 += kB) {
    __syncthreads();
    load_rows<T, D>(Ks, kp, k0, S);
    load_rows<T, D>(Vs, vp, k0, S);
    __syncthreads();
    dot_rows<D>(Qs, Ks, s, ty, tx);
    dot_rows<D>(dOs, Vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const bool ok = live(row, k0 + tx + 16 * j, S, causal, window);
        const float p = ok ? expf(s[i][j] * scale - lse[i]) : 0.f;
        dSs[(ty + 16 * i) * C::kLP + tx + 16 * j] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncthreads();
    acc_rows<D>(dSs, Ks, acc, ty, tx);
  }

  T* dqp = dq + qhead * head;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int e = 0; e < kE; ++e)
      put(dqp + static_cast<size_t>(row) * D + tx + 16 * e, acc[i][e] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int S,
                      float scale, int causal, int window) {
  using C = Tile<D>;
  constexpr int kB = C::kB, kR = C::kR, kE = C::kE;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + C::kWide;
  float* Qs = Vs + C::kWide;
  float* dOs = Qs + C::kWide;
  float* Ps = dOs + C::kWide;   // kB x kLP, rows q, columns kv
  float* dSs = Ps + C::kSquare;
  float* lse_s = dSs + C::kSquare;  // the q tile's lse and delta
  float* delta_s = lse_s + kB;

  const int k0 = blockIdx.x * kB;
  const int j = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const size_t head = static_cast<size_t>(S) * D;
  const size_t kvhead = static_cast<size_t>(b) * Hkv + j;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_rows<T, D>(Ks, k + kvhead * head, k0, S);
  load_rows<T, D>(Vs, v + kvhead * head, k0, S);

  // q tiles that hold a live row for some column of this block
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + kB - 1 + window) : S;

  float acc_k[kR][kE], acc_v[kR][kE];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc_k[i][e] = 0.f, acc_v[i][e] = 0.f;
  float s[kR][kR], dp[kR][kR];

  for (int g = 0; g < G; ++g) {
    const size_t qhead = static_cast<size_t>(b) * Hq + j * G + g;
    for (int q0 = q_begin; q0 < q_end; q0 += kB) {
      __syncthreads();
      load_rows<T, D>(Qs, q + qhead * head, q0, S);
      load_rows<T, D>(dOs, dout + qhead * head, q0, S);
      for (int r = threadIdx.x; r < kB; r += kThreads) {
        const bool in = q0 + r < S;
        lse_s[r] = in ? lse[qhead * S + q0 + r] : 0.f;
        delta_s[r] = in ? delta[qhead * S + q0 + r] : 0.f;
      }
      __syncthreads();
      dot_rows<D>(Qs, Ks, s, ty, tx);   // rows: q, columns: kv
      dot_rows<D>(dOs, Vs, dp, ty, tx);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int jj = 0; jj < kR; ++jj) {
          const int c = tx + 16 * jj;
          const bool ok = live(q0 + r, k0 + c, S, causal, window);
          const float p = ok ? expf(s[i][jj] * scale - lse_s[r]) : 0.f;
          Ps[r * C::kLP + c] = p;
          dSs[r * C::kLP + c] = p * (dp[i][jj] - delta_s[r]);
        }
      }
      __syncthreads();
      acc_cols<D>(Ps, dOs, acc_v, ty, tx);   // dV += P^T dO
      acc_cols<D>(dSs, Qs, acc_k, ty, tx);   // dK += dS^T q
    }
  }

  T* dkp = dk + kvhead * head;
  T* dvp = dv + kvhead * head;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const size_t at = static_cast<size_t>(row) * D + tx + 16 * e;
      put(dkp + at, acc_k[i][e] * scale);
      put(dvp + at, acc_v[i][e]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
           void* dk, void* dv, float* lse, float* delta, int B, int Hq, int Hkv, int S,
           float scale, int causal, int window, cudaStream_t stream) {
  using C = Tile<D>;
  const int blocks = (S + C::kB - 1) / C::kB;
  const size_t smem_dq = sizeof(float) * (4 * C::kWide + C::kSquare);
  const size_t smem_dkdv = sizeof(float) * (4 * C::kWide + 2 * C::kSquare + 2 * C::kB);
  auto k_dq = flash_bwd_dq_kernel<T, D>;
  auto k_dkdv = flash_bwd_dkdv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_dkdv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  k_dq<<<dim3(blocks, Hq, B), kThreads, smem_dq, stream>>>(
      tq, tk, tv, tdo, static_cast<T*>(dq), lse, delta, Hq, Hkv, S, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k_dkdv<<<dim3(blocks, Hkv, B), kThreads, smem_dkdv, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Hq, Hkv, S,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dtype(const void* q, const void* k, const void* v, const void* dout, void* dq,
                 void* dk, void* dv, float* lse, float* delta, int dtype, int B, int Hq,
                 int Hkv, int S, float scale, int causal, int window, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, dout, dq, dk, dv, lse, delta, B, Hq, Hkv, S, scale,
                            causal, window, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(q, k, v, dout, dq, dk, dv, lse, delta, B, Hq, Hkv, S,
                                    scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace cc

// ---------------------------------------------------------------------------
// bfloat16 at D 64 and 128: tensor cores (wgmma) fed by TMA.
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kB = 64;           // rows of a kv tile, a kv block and a q tile
constexpr int kSpan = 128;       // bytes of a swizzled row: 64 bf16 columns
constexpr int kSBO = 8 * kSpan;  // 8 rows of one swizzle atom
constexpr int kStages = 2;       // depth of each kernel's ring of tiles
constexpr float kLog2e = 1.4426950408889634f;

// No producer warp: thread 0 issues every TMA load, refilling a stage once
// every warp has released it. A ninth warp would put three warps on one of
// the SM's four register-file quarters and cap each thread at 168
// registers, which the dQ kernel's accumulators and operands exceed.
template <int D>
struct Cfg {
  static_assert(D == 64 || D == 128, "the tensor-core backward takes D 64 and 128");
  static constexpr int kBoxes = D / 64;     // 64-column TMA boxes across a row
  static constexpr int kTile = kB * D * 2;  // bytes of one 64-row tile
  // dq kernel: two warpgroups of 64 q rows; 1024 B of alignment slack, the
  // q and dO blocks, two stages of (K, V), five mbarriers
  static constexpr int kQRows = 128;
  static constexpr int kDqThreads = 256;
  static constexpr int kDqSmem = 1024 + 2 * kQRows * D * 2 + 4 * kTile + 64;
  // dkdv kernel: one warpgroup of 64 kv rows, two CTAs an SM; slack, K and
  // V, two stages of (q, dO) and of (lse, delta), five mbarriers
  static constexpr int kKvThreads = 128;
  static constexpr int kKvSmem = 1024 + 6 * kTile + 2 * 2 * kB * 4 + 64;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// acc (64 x 64) = A . B^T over D: A's 64 rows at `a` and B's at `b`, both
// (rows, D) row-major tiles of TMA boxes, the next box `a_box` / `b_box`
// bytes on; step kk is 32 bytes into box kk / 4
template <int D>
__device__ __forceinline__ void rows_dot(float* acc, uint32_t a, int a_box, uint32_t b,
                                         int b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4;
    const int off = (kk % 4) * 32;
    wgmma_ss_n64(acc, desc(a + box * a_box + off, 16, kSBO, 1),
                 desc(b + box * b_box + off, 16, kSBO, 1), kk > 0);
  }
}

// acc (64 x D) += X . T, X (64 x 64) as register fragments in two bf16
// terms (hi, lo: 16 columns each), T a 64-row (rows, D) tile at `t` read
// MN-major: rows 16kk.. start 16 swizzled rows on, and the 64-column boxes
// 64 rows apart
template <int D>
__device__ __forceinline__ void frag_dot(float* acc, const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4], uint32_t t) {
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) {
    const uint64_t d = desc(t + kk * 16 * kSpan, kB * kSpan, kSBO, 1);
    wgmma_rs<D>(acc, hi[kk], d);
    wgmma_rs<D>(acc, lo[kk], d);
  }
}

// a 64 x 64 accumulator as the A fragments of the next product, one per 16
// columns, in two bf16 terms: hi = x rounded, lo = (x - hi) rounded
__device__ __forceinline__ void to_frags(const float* x, uint32_t (&hi)[4][4],
                                         uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      split_bf16(x[8 * kk + 2 * t], x[8 * kk + 2 * t + 1], hi[kk][t], lo[kk][t]);
}

// Once every warp has released step i's stage (the arrivals its "empty"
// barrier counts), thread 0 loads step i + kStages into it with `load`.
// The rest of warp 0 waits at __syncwarp, so the warp stays converged for
// the next wgmma.
template <typename Load>
__device__ __forceinline__ void refill(uint32_t bar_empty, int i, int steps, Load load) {
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0 && i + kStages < steps) {
      mbar_wait(bar_empty + 8 * (i % kStages), (i / kStages) & 1);
      load(i + kStages);
    }
    __syncwarp();
  }
}

// Register fragments of one warpgroup (wgmma's m64nN accumulator): thread
// (warp w, lane t) holds rows 16w + t/4 and 16w + t/4 + 8; its element 4j + e
// is column 8j + 2(t%4) + (e & 1) of the first row (e < 2) or the second.
//
// One CTA per (b, h, 128-row q block): the q block's lse and delta (pass 1),
// then dQ (pass 2), each warpgroup over its own 64 rows.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kDqThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ dq, float* __restrict__ lse_out,
                       float* __restrict__ delta_out, int Hq, int Hkv, int S, int Sp,
                       float scale, int causal, int window) {
  using C = Cfg<D>;
  constexpr int kRows = C::kQRows;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need their atoms 1024-byte aligned
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + kRows * D * 2;
  const uint32_t skv = sdo + kRows * D * 2;  // stage s: K, then V
  const uint32_t bar_q = skv + kStages * 2 * C::kTile;  // five mbarriers
  const uint32_t bar_full = bar_q + 8;    // per stage: its K and V have landed
  const uint32_t bar_empty = bar_q + 24;  // per stage: every warp is done with it

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // long causal rows first
  const int qhead = b * Hq + h;
  const int kvhead = b * Hkv + h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;

  // kv tiles that hold a live column for some row of this block; each is
  // walked twice, steps i and ntiles + i
  int k_begin = 0;
  int k_end = S;
  if (causal) k_end = min(S, q0 + kRows);
  if (window > 0) k_begin = (max(0, q0 - window + 1) / kB) * kB;
  const int ntiles = (k_end - k_begin + kB - 1) / kB;
  const int steps = 2 * ntiles;
  auto load = [&](int j) {
    const int st = j % kStages;
    const uint32_t dst = skv + st * 2 * C::kTile;
    const uint32_t bar = bar_full + 8 * st;
    const int k0 = k_begin + (j % ntiles) * kB;
    mbar_expect(bar, 2 * C::kTile);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
      tma_load(dst + c * kB * kSpan, &tk, bar, 64 * c, k0, kvhead);
      tma_load(dst + C::kTile + c * kB * kSpan, &tv, bar, 64 * c, k0, kvhead);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar_q, 2 * kRows * D * 2);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
      tma_load(sq + c * kRows * kSpan, &tq, bar_q, 64 * c, q0, qhead);
      tma_load(sdo + c * kRows * kSpan, &tdo, bar_q, 64 * c, q0, qhead);
    }
    for (int j = 0; j < min(kStages, steps); ++j) load(j);
  }
  __syncthreads();

  const int r_lo = q0 + wg * 64;                             // this warpgroup's rows
  const int row0 = r_lo + (tid % 128) / 32 * 16 + lane / 4;  // and row0 + 8
  const int cq = 2 * (lane % 4);
  const uint32_t qa = sq + wg * 64 * kSpan;
  const uint32_t doa = sdo + wg * 64 * kSpan;
  const float sl = scale * kLog2e;  // logits in base 2

  float m[2] = {kNeg, kNeg};  // pass 1: running max, sum of exp, sum of exp * dP
  float l[2] = {0.f, 0.f};
  float t[2] = {0.f, 0.f};
  float lse[2] = {0.f, 0.f};  // pass 2: base-2 log-sum-exp and delta
  float delta[2] = {0.f, 0.f};
  float acc[D / 2];
  float s[kB / 2], dp[kB / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t dh[kB / 16][4], dl[kB / 16][4];

  mbar_wait(bar_q, 0);
  for (int i = 0; i < steps; ++i) {
    const bool second = i >= ntiles;
    const int k0 = k_begin + (second ? i - ntiles : i) * kB;
    const bool live = r_lo < S && (!causal || k0 <= r_lo + 63) &&
                      (window <= 0 || r_lo - (k0 + kB - 1) < window);
    // a dead tile is waited for too, so every warp arrives once on each
    // phase of a stage's "empty" barrier
    mbar_wait(bar_full + 8 * (i % kStages), (i / kStages) & 1);
    if (live) {
      const uint32_t ka = skv + (i % kStages) * 2 * C::kTile;
      const uint32_t va = ka + C::kTile;
      // S = Q . K^T and dP = dO . V^T
#pragma unroll
      for (int e = 0; e < kB / 2; ++e) s[e] = 0.f, dp[e] = 0.f;
      pin<kB / 2>(s);
      pin<kB / 2>(dp);
      wgmma_fence();
      rows_dot<D>(s, qa, kRows * kSpan, ka, kB * kSpan);
      rows_dot<D>(dp, doa, kRows * kSpan, va, kB * kSpan);
      wgmma_commit();
      wgmma_wait_all();
      pin<kB / 2>(s);
      pin<kB / 2>(dp);

      // scale in float32 (base 2), mask where the tile crosses the
      // diagonal, the window's edge or S
      const bool edge = k0 + kB > S || (causal && k0 + kB - 1 > r_lo) ||
                        (window > 0 && r_lo + 63 - k0 >= window);
#pragma unroll
      for (int e = 0; e < kB / 2; ++e) {
        float x = s[e] * sl;
        if (edge) {
          const int row = row0 + ((e & 2) ? 8 : 0);
          const int col = k0 + 8 * (e / 4) + cq + (e & 1);
          if (!(col < S && (!causal || col <= row) && (window <= 0 || row - col < window)))
            x = kNeg;
        }
        s[e] = x;
      }
      if (!second) {
        // online: each row's max, sum of exp and sum of exp * dP
        float mx[2] = {kNeg, kNeg};
#pragma unroll
        for (int e = 0; e < kB / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
        float alpha[2], ps[2] = {0.f, 0.f}, pt[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[r], quad_max(mx[r]));
          alpha[r] = fast_exp2(m[r] - mn);
          m[r] = mn;
        }
#pragma unroll
        for (int e = 0; e < kB / 2; ++e) {
          const int r = (e >> 1) & 1;
          const float p = (edge && s[e] == kNeg) ? 0.f : fast_exp2(s[e] - m[r]);
          ps[r] += p;
          pt[r] += p * dp[e];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = l[r] * alpha[r] + quad_sum(ps[r]);
          t[r] = t[r] * alpha[r] + quad_sum(pt[r]);
        }
      } else {
        // dS = P * (dP - delta), then dQ += dS . K with dS in two bf16 terms
#pragma unroll
        for (int e = 0; e < kB / 2; ++e) {
          const int r = (e >> 1) & 1;
          const float p = (edge && s[e] == kNeg) ? 0.f : fast_exp2(s[e] - lse[r]);
          dp[e] = p * (dp[e] - delta[r]);
        }
        to_frags(dp, dh, dl);
        pin<D / 2>(acc);
        wgmma_fence();
        frag_dot<D>(acc, dh, dl, ka);
        wgmma_commit();
        wgmma_wait_all();
        pin<D / 2>(acc);
      }
    }
    if (i == ntiles - 1) {
      // the rows' statistics, for pass 2 and the dkdv kernel; rows at or
      // past S (up to the padded Sp) read as 0
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const bool in = row < S && l[r] > 0.f;
        lse[r] = in ? m[r] + log2f(l[r]) : 0.f;
        delta[r] = in ? t[r] / l[r] : 0.f;
        if (lane % 4 == 0 && row < Sp) {
          lse_out[static_cast<size_t>(qhead) * Sp + row] = lse[r];
          delta_out[static_cast<size_t>(qhead) * Sp + row] = delta[r];
        }
      }
    }
    if (lane == 0) mbar_arrive(bar_empty + 8 * (i % kStages));  // this warp is done
    refill(bar_empty, i, steps, load);
  }

  __nv_bfloat16* dqp = dq + static_cast<size_t>(qhead) * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqp + static_cast<size_t>(row) * D + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// One CTA per (b, kv head j, 64-row kv block): K and V once, then the G
// query heads of the group and the q tiles that see the block, each with
// its rows' lse and delta, through a 2-stage ring. The scores are computed
// transposed (kv rows, q columns), so P^T and dS^T come out as accumulator
// fragments and enter dV += P^T dO and dK += dS^T q as the A operand; the
// group's sum happens in the accumulators.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kKvThreads, 2)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                         int Hq, int Hkv, int S, int Sp, float scale, int causal,
                         int window) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sk = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sv = sk + C::kTile;
  const uint32_t sring = sv + C::kTile;       // stage s: q, then dO
  const uint32_t sld = sring + 4 * C::kTile;  // stage s: lse[64], then delta[64]
  const uint32_t bar_kv = sld + 4 * kB * 4;
  const uint32_t bar_full = bar_kv + 8;    // per stage: its tiles have landed
  const uint32_t bar_empty = bar_kv + 24;  // per stage: every warp is done with it
  const float* ld_base = reinterpret_cast<const float*>(
      smem_raw + (sld - smem_addr(smem_raw)));

  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kB;  // causal: the longest blocks first
  const int G = Hq / Hkv;
  const int kvhead = b * Hkv + j;
  const int tid = threadIdx.x;
  const int lane = tid % 32;

  // q tiles that hold a live row for some column of this block, for each
  // of the group's heads: step i is head i / nq, tile i % nq
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + kB - 1 + window) : S;
  const int nq = (q_end - q_begin + kB - 1) / kB;
  const int steps = G * nq;
  auto load = [&](int i) {
    const int st = i % kStages;
    const int qhead = b * Hq + j * G + i / nq;
    const int q0 = q_begin + (i % nq) * kB;
    const uint32_t dst = sring + st * 2 * C::kTile;
    const uint32_t bar = bar_full + 8 * st;
    mbar_expect(bar, 2 * C::kTile + 2 * kB * 4);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
      tma_load(dst + c * kB * kSpan, &tq, bar, 64 * c, q0, qhead);
      tma_load(dst + C::kTile + c * kB * kSpan, &tdo, bar, 64 * c, q0, qhead);
    }
    const size_t at = static_cast<size_t>(qhead) * Sp + q0;
    bulk_load(sld + st * 2 * kB * 4, lse + at, kB * 4, bar);
    bulk_load(sld + st * 2 * kB * 4 + kB * 4, delta + at, kB * 4, bar);
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar_kv, 2 * C::kTile);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
      tma_load(sk + c * kB * kSpan, &tk, bar_kv, 64 * c, k0, kvhead);
      tma_load(sv + c * kB * kSpan, &tv, bar_kv, 64 * c, k0, kvhead);
    }
    for (int i = 0; i < min(kStages, steps); ++i) load(i);
  }
  __syncthreads();

  const int row0 = k0 + tid / 32 * 16 + lane / 4;  // kv rows row0 and row0 + 8
  const int cq = 2 * (lane % 4);
  const float sl = scale * kLog2e;

  float acc_k[D / 2], acc_v[D / 2];
  float s[kB / 2], dp[kB / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = 0.f, acc_v[i] = 0.f;
  uint32_t ph[kB / 16][4], pl[kB / 16][4], dh[kB / 16][4], dl[kB / 16][4];

  mbar_wait(bar_kv, 0);
  for (int i = 0; i < steps; ++i) {
    const int st = i % kStages;
    const int q0 = q_begin + (i % nq) * kB;
    const uint32_t qs = sring + st * 2 * C::kTile;
    const uint32_t dos = qs + C::kTile;
    const float* lse_s = ld_base + st * 2 * kB;
    const float* delta_s = lse_s + kB;
    mbar_wait(bar_full + 8 * st, (i / kStages) & 1);

    // S^T = K . q^T and dP^T = V . dO^T (kv rows, q columns), the
    // accumulators zeroed first as in the dQ kernel
#pragma unroll
    for (int e = 0; e < kB / 2; ++e) s[e] = 0.f, dp[e] = 0.f;
    pin<kB / 2>(s);
    pin<kB / 2>(dp);
    wgmma_fence();
    rows_dot<D>(s, sk, kB * kSpan, qs, kB * kSpan);
    rows_dot<D>(dp, sv, kB * kSpan, dos, kB * kSpan);
    wgmma_commit();
    wgmma_wait_all();
    pin<kB / 2>(s);
    pin<kB / 2>(dp);

    // P^T = exp2(S^T scale log2e - lse[col]) and dS^T = P^T (dP^T -
    // delta[col]), masked where the tile crosses the diagonal, the window's
    // edge or S
    const bool edge = q0 + kB > S || (causal && k0 + kB - 1 > q0) ||
                      (window > 0 && q0 + kB - 1 - k0 >= window);
#pragma unroll
    for (int e = 0; e < kB / 2; ++e) {
      const int c = 8 * (e / 4) + cq + (e & 1);
      bool ok = true;
      if (edge) {
        const int row = row0 + ((e & 2) ? 8 : 0);
        const int col = q0 + c;
        ok = col < S && (!causal || row <= col) && (window <= 0 || col - row < window);
      }
      const float p = ok ? fast_exp2(s[e] * sl - lse_s[c]) : 0.f;
      s[e] = p;
      dp[e] = p * (dp[e] - delta_s[c]);
    }
    to_frags(s, ph, pl);
    to_frags(dp, dh, dl);

    // dV += P^T dO and dK += dS^T q, each left factor in two bf16 terms
    pin<D / 2>(acc_v);
    pin<D / 2>(acc_k);
    wgmma_fence();
    frag_dot<D>(acc_v, ph, pl, dos);
    frag_dot<D>(acc_k, dh, dl, qs);
    wgmma_commit();
    wgmma_wait_all();
    pin<D / 2>(acc_v);
    pin<D / 2>(acc_k);
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    refill(bar_empty, i, steps, load);
  }

  __nv_bfloat16* dkp = dk + static_cast<size_t>(kvhead) * S * D;
  __nv_bfloat16* dvp = dv + static_cast<size_t>(kvhead) * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const size_t at = static_cast<size_t>(row) * D + 8 * jj + cq;
      const int e = 4 * jj + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dkp + at) =
          __floats2bfloat162_rn(acc_k[e] * scale, acc_k[e + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + at) =
          __floats2bfloat162_rn(acc_v[e], acc_v[e + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
           void* dk, void* dv, float* lse, float* delta, int B, int Hq, int Hkv, int S,
           float scale, int causal, int window, cudaStream_t stream) {
  using C = Cfg<D>;
  const int Sp = (S + kB - 1) / kB * kB;
  CUtensorMap tq, tdo, tk, tv, tq64, tdo64;
  if (!make_map(&tq, q, S, B * Hq, D, 64, C::kQRows) ||
      !make_map(&tdo, dout, S, B * Hq, D, 64, C::kQRows) ||
      !make_map(&tq64, q, S, B * Hq, D, 64, kB) ||
      !make_map(&tdo64, dout, S, B * Hq, D, 64, kB) ||
      !make_map(&tk, k, S, B * Hkv, D, 64, kB) || !make_map(&tv, v, S, B * Hkv, D, 64, kB))
    return static_cast<int>(cudaErrorInvalidValue);
  auto k_dq = flash_bwd_dq_tc_kernel<D>;
  auto k_dkdv = flash_bwd_dkdv_tc_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDqSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kKvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k_dq<<<dim3(Hq, B, (S + C::kQRows - 1) / C::kQRows), C::kDqThreads, C::kDqSmem, stream>>>(
      tq, tdo, tk, tv, static_cast<__nv_bfloat16*>(dq), lse, delta, Hq, Hkv, S, Sp, scale,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k_dkdv<<<dim3(Hkv, B, Sp / kB), C::kKvThreads, C::kKvSmem, stream>>>(
      tq64, tdo64, tk, tv, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Hq, Hkv, S, Sp, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// q and dout (B, Hq, S, D), k and v (B, Hkv, S, D), contiguous and 16-byte
// aligned, of one dtype (0: float32, 1: bfloat16); dq, dk, dv the same
// shapes and dtype; lse and delta float32 scratch of B * Hq * Sp rows (Sp
// = S rounded up to 64) that the first kernel writes and the second reads;
// D in {16, 32, 64, 80, 128, 256}; window <= 0 means none. tensor_cores 1 takes
// the tensor-core kernels (bfloat16 at D 64 or 128 only), 0 the CUDA-core
// ones. Launches the two kernels on `stream`; returns the cudaError_t
// (cudaErrorInvalidValue for a route the inputs cannot take or a tensor map
// that cannot be encoded).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          float* lse, float* delta, int dtype,
                                          int tensor_cores, int B, int Hq, int Hkv, int S,
                                          int D, float scale, int causal, int window,
                                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (D == 64)
      return tc::launch<64>(q, k, v, dout, dq, dk, dv, lse, delta, B, Hq, Hkv, S, scale,
                            causal, window, st);
    if (D == 128)
      return tc::launch<128>(q, k, v, dout, dq, dk, dv, lse, delta, B, Hq, Hkv, S, scale,
                             causal, window, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define FLASH_BWD_CASE(DIM)                                                              \
  case DIM:                                                                              \
    return cc::launch_dtype<DIM>(q, k, v, dout, dq, dk, dv, lse, delta, dtype, B, Hq,   \
                                 Hkv, S, scale, causal, window, st);
  switch (D) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(80)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_CASE
}
