// Causal GQA prefill attention with an optional sliding window, online
// softmax over kv tiles, float32 inside.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel). For query head h of batch row b it computes
// softmax(mask(q * scale . k^T)) . v against kv head h / (Hq / Hkv), the
// mask being cols < S, cols <= rows (causal) and rows - cols < window;
// masked logits are -1e30 and their probabilities are zeroed; the output
// is acc / max(l, 1e-30) in q's dtype. q is scaled in float32 before the
// product, as the reference scales it.
//
// What bounds it on the H100: operations. At the serving shape (B=4,
// Hq=32, S=1000, D=128, causal) the call needs 4*B*Hq*D*S(S+1)/2 = 3.3e10
// FLOP against 82 MB of q, k, v and output, ~400 FLOP per byte, above the
// bf16 tensor-core ridge (~295). This first version does its products on
// the float32 CUDA cores (explicit fmaf), which keeps float32 inputs exact
// to float32 rounding and makes one code path for float32 and bf16; the
// tensor cores (wgmma) are a later speed item.
//
// Design. The Pallas grid (B, Hq, nq, nk) carries m, l and acc in VMEM
// across its sequential kv axis; Hopper blocks run in no order, so here one
// CTA owns one (b, h, 64-row q block) and loops over the 64-row kv tiles
// itself. The scaled q block, the current K and V tiles (as float32) and
// the probability tile sit in shared memory (115 KB at D=128, set with
// cudaFuncSetAttribute). Thread t holds rows 4*(t/16)..+3: for the logits
// it computes a 4x4 sub-block (cols t%16 + 16j), for the output the dims
// t%16 + 16i of the same 4 rows, so the running max, normaliser and
// accumulator of a row live in the registers of the 16 threads that share
// it (shuffle reductions within each 16-lane half-warp). Rows of q and K
// are padded by one float so the column reads hit 16 distinct banks.
// Tiles wholly above the causal diagonal or outside the window are
// skipped; a partial tile is masked element by element. Rows and columns
// past S are bounds-checked (zero-filled on load, never stored), so S
// needs no padding copy. q blocks are scheduled last-first so the long causal
// rows start first.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows per CTA
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kLDP = kBK + 1;  // padded probability row
constexpr float kNeg = -1e30f;

__device__ __forceinline__ void load4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* x) {
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(v[0]);
  const float2 b = __bfloat1622float2(v[1]);
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [row0, row0 + rows) of a (S, D) head into dst (leading dim ld) as
// float32 times mul; rows at or past S are zero.
template <typename T, int D>
__device__ void load_tile(float* dst, int ld, const T* src, int row0, int rows,
                          int S, float mul) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) load4(src + static_cast<size_t>(row0 + r) * D + c, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[r * ld + c + j] = x[j] * mul;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * (D + 1) + static_cast<size_t>(kBK) * (D + 1) +
          static_cast<size_t>(kBK) * D + static_cast<size_t>(kBQ) * kLDP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
             int S, float scale, int causal, int window) {
  constexpr int kLD = D + 1;
  constexpr int kND = D / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // kBQ x kLD, scaled q
  float* Ks = Qs + kBQ * kLD;   // kBK x kLD
  float* Vs = Ks + kBK * kLD;   // kBK x D
  float* Ps = Vs + kBK * D;     // kBQ x kLDP

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qb * kBQ;
  const size_t head = static_cast<size_t>(S) * D;
  const T* qp = q + (static_cast<size_t>(b) * Hq + h) * head;
  const T* kp = k + (static_cast<size_t>(b) * Hkv + kvh) * head;
  const T* vp = v + (static_cast<size_t>(b) * Hkv + kvh) * head;
  T* op = o + (static_cast<size_t>(b) * Hq + h) * head;

  const int rg = threadIdx.x / 16;  // rows 4*rg .. 4*rg + 3 of the block
  const int cg = threadIdx.x % 16;  // logit cols cg + 16j, output dims cg + 16i

  load_tile<T, D>(Qs, kLD, qp, q0, kBQ, S, scale);

  float m[4], l[4], acc[4][kND];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kND; ++e) acc[i][e] = 0.f;
  }

  // kv tiles that hold a live column for some row of this block
  int k_begin = 0;
  int k_end = S;
  if (causal) k_end = min(S, q0 + kBQ);
  if (window > 0) k_begin = (max(0, q0 - window + 1) / kBK) * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, D>(Ks, kLD, kp, k0, kBK, S, 1.f);
    load_tile<T, D>(Vs, D, vp, k0, kBK, S, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * kLD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(cg + 16 * j) * kLD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      bool ok[4];
      float mt = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        ok[j] = col < S && (!causal || col <= row) &&
                (window <= 0 || row - col < window);
        if (!ok[j]) s[i][j] = kNeg;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        Ps[(rg * 4 + i) * kLDP + cg + 16 * j] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kND; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg * 4 + i) * kLDP + c];
#pragma unroll
      for (int e = 0; e < kND; ++e) {
        const float vv = Vs[c * D + cg + 16 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(pv[i], vv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < kND; ++e)
      store(op + static_cast<size_t>(row) * D + cg + 16 * e, acc[i][e] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int S, float scale, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, S, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int Hq,
             int Hkv, int S, int D, float scale, int causal, int window,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, S, scale, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, S, scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, scale, causal, window, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, Hq, Hkv, S, scale, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Hq, S, D), k and v (B, Hkv, S, D), o (B, Hq, S, D), contiguous, of
// one dtype (0: float32, 1: bfloat16); D in {16, 32, 64, 128, 256};
// window <= 0 means none. Launches on `stream`; returns the cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int dtype, int B, int Hq, int Hkv,
                                      int S, int D, float scale, int causal,
                                      int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, Hq, Hkv, S, D, scale, causal, window, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, D, scale, causal,
                                   window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
