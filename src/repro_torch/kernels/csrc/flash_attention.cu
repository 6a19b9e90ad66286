// Causal GQA prefill attention with an optional sliding window, online
// softmax over kv tiles, float32 inside. Two kernels, chosen by dtype alone:
// bfloat16 runs on the tensor cores (wgmma, TMA), float32 on the CUDA cores.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel). For query head h of batch row b it computes
// softmax(mask(q . k^T * scale)) . v against kv head h / (Hq / Hkv), the
// mask being cols < S, cols <= rows (causal) and rows - cols < window;
// masked logits are -1e30 and their probabilities are zeroed; the output
// is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the H100: operations. At the serving shape (B=4,
// Hq=32, S=1000, D=128, bf16, causal) the call needs 4*B*Hq*D*S(S+1)/2 =
// 3.3e10 FLOP against 82 MB of q, k, v and output, ~400 FLOP per byte,
// above the bf16 tensor-core ridge (~295): only the tensor cores bring it
// near its bound.
//
// bfloat16: flash_tc_kernel. The Pallas grid (B, Hq, nq, nk) carries m, l
// and acc in VMEM across its sequential kv axis; Hopper blocks run in no
// order, so one CTA owns one (b, h, 128-row q block) and walks the 64-row
// kv tiles of that block itself. Two consumer warpgroups hold 64 q rows
// each (one warpgroup of 64 rows at D = 256, to fit the registers), and
// one producer warp loads.
// - Loads. The producer warp loads the q block once and the K and V tiles
//   through a 2-stage ring in shared memory with TMA (cp.async.bulk.tensor):
//   a stage's "full" mbarrier completes when its bytes have landed, its
//   "empty" mbarrier when every consumer warp is done with it, and only
//   then is the next tile loaded into it. Tile i + 1 is in flight while
//   tile i is multiplied, and the warpgroups never wait for each other, so
//   one's softmax overlaps the other's products. The tensor maps are 3-D,
//   (D, S, B*H), so rows past S in a box are out of bounds and arrive as
//   zeros. Rows are swizzled by 128 bytes (64 bf16), so a row of D > 64
//   comes as D / 64 boxes of 64 columns; D = 16 and 32 use the 32- and
//   64-byte swizzles, and D = 80, whose 160-byte rows no 128- or 64-byte
//   box divides, five 32-byte boxes of 16 columns: Q . K^T then takes one
//   box a k-step, and P . V is one n80 product whose MN-major V spans the
//   five boxes (leading byte offset: one box, as the two boxes of D = 128).
// - Products. S = Q . K^T is wgmma m64n64k16 with both operands in shared
//   memory (K-major), float32 accumulators in registers. The scale is
//   applied in float32 after the product (the reference scales q before:
//   the difference is float32 rounding of the logits). Mask and online
//   softmax run in registers, a row's max and sum across the 4 threads of
//   a quad, the exponentials as ex2.approx, cheaper than exp2f: the
//   softmax's instructions sit on each warpgroup's path between its two
//   products. O += P . V is a second wgmma with P in registers as the A
//   operand (the m64nNk16 accumulator fragment is the A fragment of the
//   next product) and V the B operand in its natural (kv, D) layout, read
//   MN-major. P goes in as two bf16 terms, hi = P rounded and lo = P - hi
//   rounded, two products: one bf16 P is off by up to 2^-8 of each
//   probability, which at a row of few terms whose values cancel moves a
//   small output by more than 2e-3 + 2^-6 of itself; two terms carry ~16
//   bits (tests/test_torch_attention.py models both). That doubles P . V's
//   tensor-core work (1.5x in all).
// - Skips. Tiles wholly above the causal diagonal or outside the window
//   of a warpgroup's rows are skipped; only tiles that cross the diagonal,
//   the window's edge or S are masked element by element. q blocks run
//   last-first, so the long causal rows start first.
// - Not yet: register reallocation between the roles (setmaxnreg), an
//   explicit ping-pong schedule of the warpgroups, overlap of one tile's
//   softmax with the next tile's Q . K^T within a warpgroup, and GQA
//   packing of the q heads that share a kv tile.
//
// float32: flash_f32_kernel, on the float32 CUDA cores (explicit fmaf),
// exact to float32 rounding; no served path runs it. One CTA per (b, h,
// 64-row q block); the scaled q block, the K and V tiles and the
// probability tile sit in shared memory (115 KB at D=128). Thread t holds
// rows 4*(t/16)..+3: for the logits it computes a 4x4 sub-block (cols t%16
// + 16j), for the output the dims t%16 + 16i of the same 4 rows, so a
// row's max, normaliser and accumulator live in the 16 threads that share
// it. q is scaled in float32 before the product, as the reference does.
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA cores.
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kBQ = 64;        // q rows per CTA
constexpr int kBK = 64;        // kv rows per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kLDP = kBK + 1;  // padded probability row

// rows [row0, row0 + rows) of a (S, D) head into dst (leading dim ld) times
// mul; rows at or past S are zero.
template <int D>
__device__ void load_tile(float* dst, int ld, const float* src, int row0, int rows,
                          int S, float mul) {
  constexpr int kVecs = D / 4;
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S)
      x = *reinterpret_cast<const float4*>(src + static_cast<size_t>(row0 + r) * D + c);
    float* d = dst + r * ld + c;
    d[0] = x.x * mul; d[1] = x.y * mul; d[2] = x.z * mul; d[3] = x.w * mul;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Hq, int Hkv,
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
  const float* qp = q + (static_cast<size_t>(b) * Hq + h) * head;
  const float* kp = k + (static_cast<size_t>(b) * Hkv + kvh) * head;
  const float* vp = v + (static_cast<size_t>(b) * Hkv + kvh) * head;
  float* op = o + (static_cast<size_t>(b) * Hq + h) * head;

  const int rg = threadIdx.x / 16;  // rows 4*rg .. 4*rg + 3 of the block
  const int cg = threadIdx.x % 16;  // logit cols cg + 16j, output dims cg + 16i

  load_tile<D>(Qs, kLD, qp, q0, kBQ, S, scale);

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
    load_tile<D>(Ks, kLD, kp, k0, kBK, S, 1.f);
    load_tile<D>(Vs, D, vp, k0, kBK, S, 1.f);
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
      op[static_cast<size_t>(row) * D + cg + 16 * e] = acc[i][e] / denom;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int S, float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_f32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, S, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma) fed by TMA.
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kBK = 64;  // kv rows per tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kWG = D == 256 ? 1 : 2;  // consumer warpgroups, 64 q rows each
  static constexpr int kBQ = 64 * kWG;          // q rows per CTA
  static constexpr int kThreads = 128 * kWG + 32;  // and one producer warp
  // bytes of a swizzled row: the largest of the 128, 64 and 32-byte swizzles
  // that divides a row of D bf16 (D 80: 32 bytes, five boxes of 16 columns)
  static constexpr int kSpan = (2 * D) % 128 == 0 ? 128 : (2 * D) % 64 == 0 ? 64 : 32;
  static constexpr int kBoxCols = kSpan / 2;               // columns of one TMA box
  static constexpr int kBoxes = D / kBoxCols;              // boxes across a row
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;           // one K or V tile
  // wgmma's swizzle code for the span: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kMode = kSpan == 128 ? 1 : kSpan == 64 ? 2 : 3;
  static constexpr int kNC = D < 128 ? D : 128;            // columns of one P.V wgmma
  static_assert((2 * D) % kSpan == 0 && D % 16 == 0, "D must be a multiple of 16");
  // 1024 B of alignment slack, q, two stages of (K, V), five mbarriers
  static constexpr int kSmem = 1024 + kQBytes + 4 * kTileBytes + 64;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Register fragments of one warpgroup (wgmma's m64nN accumulator): thread
// (warp w, lane t) holds rows 16w + t/4 and 16w + t/4 + 8; its element 4j + e
// is column 8j + 2(t%4) + (e & 1) of the first row (e < 2) or the second.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                int Hq, int Hkv, int S, float scale, int causal, int window) {
  using C = Cfg<D>;
  constexpr int kSpan = C::kSpan;
  constexpr int kSBO = 8 * kSpan;  // 8 rows of one swizzle atom
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need their atoms 1024-byte aligned
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t skv = sq + C::kQBytes;         // stage s: K, then V
  const uint32_t bar_q = skv + 4 * C::kTileBytes;
  const uint32_t bar_full = bar_q + 8;    // per stage: its K and V have landed
  const uint32_t bar_empty = bar_q + 24;  // per stage: every consumer warp is done

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::kBQ;
  const int qhead = b * Hq + h;
  const int kvhead = b * Hkv + h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;

  // kv tiles that hold a live column for some row of this block
  int k_begin = 0;
  int k_end = S;
  if (causal) k_end = min(S, q0 + C::kBQ);
  if (window > 0) k_begin = (max(0, q0 - window + 1) / kBK) * kBK;
  const int ntiles = (k_end - k_begin + kBK - 1) / kBK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, 4 * C::kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C::kWG) {
    // the producer warp: q once, then each tile into its stage as soon as
    // every consumer warp has released the tile that held it before
    if (lane == 0) {
      mbar_expect(bar_q, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kBoxes; ++c)
        tma_load(sq + c * C::kBQ * kSpan, &tq, bar_q, c * C::kBoxCols, q0, qhead);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i & 1;
        if (i >= 2) mbar_wait(bar_empty + 8 * st, ((i >> 1) - 1) & 1);
        const uint32_t dst = skv + st * 2 * C::kTileBytes;
        const int k0 = k_begin + i * kBK;
        mbar_expect(bar_full + 8 * st, 2 * C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kBoxes; ++c) {
          tma_load(dst + c * kBK * kSpan, &tk, bar_full + 8 * st, c * C::kBoxCols, k0,
                   kvhead);
          tma_load(dst + C::kTileBytes + c * kBK * kSpan, &tv, bar_full + 8 * st,
                   c * C::kBoxCols, k0, kvhead);
        }
      }
    }
    return;
  }

  const int r_lo = q0 + wg * 64;                      // this warpgroup's rows
  const int row0 = r_lo + (tid % 128) / 32 * 16 + lane / 4;  // and row0 + 8
  const int cq = 2 * (lane % 4);
  const uint32_t qa = sq + wg * 64 * kSpan;

  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float acc[D / 2];
  float s[kBK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  uint32_t ph[kBK / 16][4], pl[kBK / 16][4];

  mbar_wait(bar_q, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int k0 = k_begin + i * kBK;
    const bool live = r_lo < S && (!causal || k0 <= r_lo + 63) &&
                      (window <= 0 || r_lo - (k0 + kBK - 1) < window);
    // a dead tile is waited for too, so this warp never arrives twice on
    // one phase of a stage's "empty" barrier
    mbar_wait(bar_full + 8 * (i & 1), (i >> 1) & 1);
    if (live) {
      const uint32_t ka = skv + (i & 1) * 2 * C::kTileBytes;
      const uint32_t va = ka + C::kTileBytes;

      // S = Q . K^T over D in steps of 16: step kk is 32 bytes into box
      // kk / (kSpan / 32) of each operand
      pin<kBK / 2>(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk / (kSpan / 32);
        const int off = (kk % (kSpan / 32)) * 32;
        wgmma_ss_n64(s, desc(qa + box * C::kBQ * kSpan + off, 16, kSBO, C::kMode),
                     desc(ka + box * kBK * kSpan + off, 16, kSBO, C::kMode), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin<kBK / 2>(s);

      // scale in float32, mask where the tile crosses the diagonal, the
      // window's edge or S; online softmax per row
      const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > r_lo) ||
                        (window > 0 && r_lo + 63 - k0 >= window);
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        float x = s[e] * scale;
        if (edge) {
          const int row = row0 + ((e & 2) ? 8 : 0);
          const int col = k0 + 8 * (e / 4) + cq + (e & 1);
          if (!(col < S && (!causal || col <= row) && (window <= 0 || row - col < window)))
            x = kNeg;
        }
        s[e] = x;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
      }
      float alpha[2], mb[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = fast_exp2((m[r] - mn) * kLog2e);
        mb[r] = mn * kLog2e;
        m[r] = mn;
      }
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        const int r = (e >> 1) & 1;
        const float p =
            (edge && s[e] == kNeg) ? 0.f : fast_exp2(__fmaf_rn(s[e], kLog2e, -mb[r]));
        sum[r] += p;
        s[e] = p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      // P as the A fragments of the next product, one per 16 kv rows, in
      // two bf16 terms: hi = P rounded, lo = (P - hi) rounded
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int t = 0; t < 4; ++t) split_bf16(s[8 * kk + 2 * t], s[8 * kk + 2 * t + 1],
                                               ph[kk][t], pl[kk][t]);

      // O += P . V: kv rows 16kk.. of V start 16 swizzled rows further on;
      // column chunk c starts c * kNC / kBoxCols boxes further on
      pin<D / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < D / C::kNC; ++c) {
          const uint64_t dv =
              desc(va + kk * 16 * kSpan + c * (C::kNC / C::kBoxCols) * kBK * kSpan,
                   kBK * kSpan, kSBO, C::kMode);
          wgmma_rs<C::kNC>(acc + c * C::kNC / 2, ph[kk], dv);
          wgmma_rs<C::kNC>(acc + c * C::kNC / 2, pl[kk], dv);
        }
      wgmma_commit();
      wgmma_wait_all();
      pin<D / 2>(acc);
    }
    if (lane == 0) mbar_arrive(bar_empty + 8 * (i & 1));  // this warp is done with it
  }

  __nv_bfloat16* op = o + static_cast<size_t>(qhead) * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + static_cast<size_t>(row) * D + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int S, float scale, int causal, int window, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, S, B * Hq, D, C::kBoxCols, C::kBQ) ||
      !make_map(&tk, k, S, B * Hkv, D, C::kBoxCols, kBK) ||
      !make_map(&tv, v, S, B * Hkv, D, C::kBoxCols, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_tc_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hq, B, (S + C::kBQ - 1) / C::kBQ);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, S, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// dtype 0: float32 on the CUDA cores; 1: bfloat16 on the tensor cores
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int dtype, int B,
           int Hq, int Hkv, int S, float scale, int causal, int window,
           cudaStream_t stream) {
  if (dtype == 0)
    return f32::launch<D>(q, k, v, o, B, Hq, Hkv, S, scale, causal, window, stream);
  if (dtype == 1)
    return tc::launch<D>(q, k, v, o, B, Hq, Hkv, S, scale, causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, Hq, S, D), k and v (B, Hkv, S, D), o (B, Hq, S, D), contiguous and
// 16-byte aligned, of one dtype (0: float32 -> CUDA cores, 1: bfloat16 ->
// tensor cores); D in {16, 32, 64, 80, 128, 256}; window <= 0 means none.
// Launches on `stream`; returns the cudaError_t (cudaErrorInvalidValue when
// a tensor map cannot be encoded).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int dtype, int B, int Hq, int Hkv,
                                      int S, int D, float scale, int causal,
                                      int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, dtype, B, Hq, Hkv, S, scale, causal, window, st);
    case 32: return launch<32>(q, k, v, o, dtype, B, Hq, Hkv, S, scale, causal, window, st);
    case 64: return launch<64>(q, k, v, o, dtype, B, Hq, Hkv, S, scale, causal, window, st);
    case 80: return launch<80>(q, k, v, o, dtype, B, Hq, Hkv, S, scale, causal, window, st);
    case 128: return launch<128>(q, k, v, o, dtype, B, Hq, Hkv, S, scale, causal, window, st);
    case 256: return launch<256>(q, k, v, o, dtype, B, Hq, Hkv, S, scale, causal, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
