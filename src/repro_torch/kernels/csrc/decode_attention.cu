// GQA decode attention: one query token per head against a KV cache,
// online softmax over cache tiles, float32 inside.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (body _decode_kernel). For batch row b and kv head h it serves the G =
// Hq / Hkv query heads h*G .. h*G + G - 1 (q viewed as (B, Hkv, G, D)):
// softmax(q * scale . k^T) . v over the first length[b] cache slots, masked
// logits at -1e30 with their probabilities zeroed, output acc / max(l,
// 1e-30) in q's dtype. A row with length 0 gets zeros, as the TPU kernel
// gives; a length past S counts as S.
//
// What bounds it on the H100: bytes. Each cache slot's K and V row is read
// once and used for G heads, ~4G FLOP per 4 bytes of bf16 at D=128 (G=4 at
// the serving shape), far below the ridge. At (B=4, Hkv=8, S=1016, D=128)
// the K/V rows of the cache are 16.6 MB, ~5 us at 3.35 TB/s.
//
// Design. The Pallas grid (B, Hkv, nk) runs the kv axis in order with m, l,
// acc in VMEM; here one CTA per (b, kv head) walks the cache itself in
// 64-slot tiles, stopping at length[b] (tiles past it are never read). A
// tile's K (rows padded by one float, so a warp's 32 rows hit 32 banks)
// and V go to shared memory as float32; one thread per (slot, head)
// computes a whole logit; one warp per head updates that head's running
// max and normaliser; then every thread updates its own (head, dim)
// accumulators. Dot products run as four independent partial sums, which
// keeps the FMA chains short. Only B * Hkv = 32 CTAs run at the serving
// shape, so one CTA's per-tile latency sets the time; a split-KV grid
// that spreads the cache over the SMs is a later speed item.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;        // cache slots per tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// rows [row0, row0 + kBK) of a (S, D) cache head into dst (leading dim
// ld) as float32; rows at or past S are zero.
template <typename T, int D>
__device__ void load_tile(float* dst, int ld, const T* src, int row0, int S) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < kBK * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) load4(src + static_cast<size_t>(row0 + r) * D + c, x);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[r * ld + c + j] = x[j];
  }
}

template <int D>
size_t smem_bytes(int G) {
  // Qs (G x D), Ks (kBK x (D + 1)), Vs (kBK x D), Ps (G x kBK), Acc (G x D),
  // m, l, alpha (G)
  return sizeof(float) * (2 * static_cast<size_t>(G) * D +
                          static_cast<size_t>(kBK) * (2 * D + 1) +
                          static_cast<size_t>(G) * kBK + 3 * static_cast<size_t>(G));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ length,
              T* __restrict__ o, int Hkv, int G, int S, float scale) {
  constexpr int kLDK = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;               // G x D, scaled q
  float* Ks = Qs + G * D;         // kBK x kLDK
  float* Vs = Ks + kBK * kLDK;    // kBK x D
  float* Ps = Vs + kBK * D;       // G x kBK logits, then probabilities
  float* Acc = Ps + G * kBK;      // G x D
  float* Ms = Acc + G * D;        // G running max
  float* Ls = Ms + G;             // G running normaliser
  float* As = Ls + G;             // G rescale of this tile

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(max(length[b], 0), S);
  const size_t head = static_cast<size_t>(S) * D;
  const T* qp = q + (static_cast<size_t>(b) * Hkv + kvh) * G * D;
  const T* kp = k + (static_cast<size_t>(b) * Hkv + kvh) * head;
  const T* vp = v + (static_cast<size_t>(b) * Hkv + kvh) * head;
  T* op = o + (static_cast<size_t>(b) * Hkv + kvh) * G * D;

  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    Qs[i] = to_float(qp[i]) * scale;
    Acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    Ms[g] = kNeg;
    Ls[g] = 0.f;
  }

  for (int k0 = 0; k0 < len; k0 += kBK) {
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, D>(Ks, kLDK, kp, k0, S);
    load_tile<T, D>(Vs, D, vp, k0, S);
    __syncthreads();

    for (int e = threadIdx.x; e < kBK * G; e += kThreads) {
      const int j = e % kBK;
      const int g = e / kBK;
      const float* kr = Ks + j * kLDK;
      const float* qr = Qs + g * D;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        a0 = fmaf(qr[d], kr[d], a0);
        a1 = fmaf(qr[d + 1], kr[d + 1], a1);
        a2 = fmaf(qr[d + 2], kr[d + 2], a2);
        a3 = fmaf(qr[d + 3], kr[d + 3], a3);
      }
      Ps[g * kBK + j] = k0 + j < len ? (a0 + a1) + (a2 + a3) : kNeg;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      const bool ok0 = k0 + lane < len;
      const bool ok1 = k0 + lane + 32 < len;
      const float s0 = Ps[g * kBK + lane];
      const float s1 = Ps[g * kBK + lane + 32];
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      Ps[g * kBK + lane] = p0;
      Ps[g * kBK + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        Ls[g] = Ls[g] * alpha + psum;
        Ms[g] = m_new;
        As[g] = alpha;
      }
    }
    __syncthreads();

    for (int e = threadIdx.x; e < G * D; e += kThreads) {
      const int g = e / D;
      const int d = e % D;
      const float* pg = Ps + g * kBK;
      const float* vc = Vs + d;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
      for (int j = 0; j < kBK; j += 4) {
        a0 = fmaf(pg[j], vc[j * D], a0);
        a1 = fmaf(pg[j + 1], vc[(j + 1) * D], a1);
        a2 = fmaf(pg[j + 2], vc[(j + 2) * D], a2);
        a3 = fmaf(pg[j + 3], vc[(j + 3) * D], a3);
      }
      Acc[e] = Acc[e] * As[g] + ((a0 + a1) + (a2 + a3));
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < G * D; e += kThreads)
    store(op + e, Acc[e] / fmaxf(Ls[e / D], 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* length, void* o,
           int B, int Hkv, int G, int S, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(G);
  auto kernel = decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      length, static_cast<T*>(o), Hkv, G, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const int* length, void* o,
             int B, int Hkv, int G, int S, int D, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, length, o, B, Hkv, G, S, scale, stream);
    case 32: return launch<T, 32>(q, k, v, length, o, B, Hkv, G, S, scale, stream);
    case 64: return launch<T, 64>(q, k, v, length, o, B, Hkv, G, S, scale, stream);
    case 128: return launch<T, 128>(q, k, v, length, o, B, Hkv, G, S, scale, stream);
    case 256: return launch<T, 256>(q, k, v, length, o, B, Hkv, G, S, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Hkv * G, D), k and v (B, Hkv, S, D), length (B,) int32, o like q,
// contiguous, of one dtype (0: float32, 1: bfloat16); D in {16, 32, 64,
// 128, 256}. Launches on `stream`; returns the cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* length, void* o, int dtype, int B,
                                       int Hkv, int G, int S, int D, float scale,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, length, o, B, Hkv, G, S, D, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, length, o, B, Hkv, G, S, D, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
