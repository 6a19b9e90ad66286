// Backward of the causal GQA prefill attention (flash_attention.cu): dQ, dK
// and dV of O = softmax(mask(q . k^T * scale)) . v, float32 inside, for
// bfloat16 and float32 inputs.
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
// FLOP against 34 MB of q, k, v, dO and gradients, ~320 FLOP per byte. This
// first design runs on the float32 CUDA cores (explicit fmaf), far from the
// tensor cores' rate; wgmma and TMA come later.
//
// The design: two kernels, no atomics, so every gradient element is written
// by one thread in one fixed order and two runs give the same bits.
// - flash_bwd_dq_kernel: one CTA per (b, h, kB-row q block). A first pass
//   over the kv tiles recomputes s and dP and carries each row's running
//   max, sum of exp and sum of exp * dP (an online softmax), giving lse and
//   delta, which it writes for the second kernel; a second pass recomputes
//   s and dP, forms dS and accumulates dQ += dS . k in registers.
// - flash_bwd_dkdv_kernel: one CTA per (b, kv head, kB-row kv block). It
//   walks the G query heads of its group and the q tiles that see its kv
//   rows (the causal diagonal and the window bound the range), recomputes P
//   and dS from lse and delta, and accumulates dV += P^T dO and dK += dS^T q
//   in registers: the sum over the group's heads happens inside the CTA.
// Tiles sit in shared memory as float32 (bfloat16 inputs widened exactly),
// rows padded by one word so that no two threads of a half-warp hit one
// bank. 256 threads as 16 x 16: thread (ty, tx) owns rows ty + 16 i of a
// tile and columns tx + 16 j (a kB x kB product) or tx + 16 e (a D-wide
// one), so a row's reductions are shuffles within its half-warp. kB is 64,
// 32 at D = 256 (shared memory).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
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

}  // namespace

// q and dout (B, Hq, S, D), k and v (B, Hkv, S, D), contiguous, of one dtype
// (0: float32, 1: bfloat16); dq, dk, dv the same shapes and dtype; lse and
// delta (B, Hq, S) float32 scratch the first kernel writes and the second
// reads; D in {16, 32, 64, 128, 256}; window <= 0 means none. Launches the
// two kernels on `stream`; returns the cudaError_t.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          float* lse, float* delta, int dtype, int B, int Hq,
                                          int Hkv, int S, int D, float scale, int causal,
                                          int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_CASE(DIM)                                                                 \
  case DIM:                                                                                 \
    return launch_dtype<DIM>(q, k, v, dout, dq, dk, dv, lse, delta, dtype, B, Hq, Hkv, S, \
                             scale, causal, window, st);
  switch (D) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_CASE
}
