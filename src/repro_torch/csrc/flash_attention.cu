// Flash attention forward (prefill) for NVIDIA Hopper, written by hand.
//
// Replaces the TPU kernel `flash_attention` -> `_kernel` of
// src/repro/kernels/flash_attention.py and computes the same function:
// q (B,Sq,H,D), k/v (B,T,KH,D), bf16 or f32, out (B,Sq,H,D) in q's dtype;
// grouped-query attention (each kv head serves G = H/KH query heads); q is
// scaled by D**-0.5 in f32 before the product; the online-softmax state
// m, l, acc is f32; causal and sliding-window masks come from absolute
// positions (q position p sees key j when j <= p and j > p - window); kv tiles
// outside [lo, hi) for a block are skipped. Masked scores take the finite
// value -1e30, as in the TPU kernel: a tile that is fully masked for a row
// gives p = 1 there until a tile with a real score resets the row through
// alpha = exp(m - m_new) = 0, so no inf - inf ever makes a NaN.
//
// What bounds it on the H100: at the prefill shapes of the serving path
// (Sq = T <= 1024, D = 128) a block reads its q tile once and streams every
// k/v tile of its range once, so the bytes are ~ (q + k + v + o) and the work
// is ~4*D flops per unmasked (query, key) pair; at T >= a few hundred the
// function is bound by operations, not bytes.
//
// What this design does about it, and what it leaves for later: the TPU
// kernel keeps a kv head's whole (T, D) k/v in VMEM and folds the G query
// heads into its rows. Here one block owns (batch, kv head, q tile of
// 64 / G positions x G heads = 64 rows) and streams 64-key tiles of k and v
// through shared memory, so k/v are read from device memory once per q tile
// and never held whole. Both products run as plain f32 FMA on CUDA cores
// from shared memory: the block's threads form 16 row groups x CG column
// groups, and each thread owns a 4 x 64/CG score micro-tile and a 4 x D/CG
// output micro-tile; padded strides keep the shared-memory reads free of
// bank conflicts. D <= 128 runs 128 threads (CG = 8). D = 256 (the hybrid
// family's local attention) runs 256 threads (CG = 16), so a thread still
// holds 4 x 16 output accumulators rather than 4 x 32, which would spill;
// its tiles take 213,760 bytes of shared memory, one block per SM. Shared
// memory, not registers, limits the blocks per SM at D >= 128, so the
// launch bounds let the compiler use registers up to one block per SM
// (without that it held D = 256 to 128 registers and spilled). The f32 FMA
// keeps f32 inputs in IEEE f32 (no TF32), and it runs far below the tensor
// cores' rate: wgmma with TMA-fed tiles is the later step. Ragged edges (Sq or T not a multiple of a tile)
// are masked, not asserted away.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // q rows per block: (position, group) pairs
constexpr int kKv = 64;        // keys per k/v tile
constexpr float kNegInf = -1e30f;

// column groups per row group: D <= 128 takes 8 (128 threads), D = 256 16
// (256 threads)
template <int D>
constexpr int col_groups() { return D > 128 ? 16 : 8; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // q tile [kRows][D+1], k tile [kKv][D+1], v tile [kKv][D], p tile
  // [kRows][kKv+1], all f32
  return sizeof(float) *
         (kRows * (D + 1) + kKv * (D + 1) + kKv * D + kRows * (kKv + 1));
}

template <typename T, int D, int CG = col_groups<D>()>
__global__ void __launch_bounds__(16 * CG, 1)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Sq, int Tk,
              int H, int KH, int causal, int window, float scale) {
  constexpr int DP = D + 1;    // padded row stride of the q and k tiles
  constexpr int PP = kKv + 1;  // padded row stride of the p tile
  constexpr int kThreads = 16 * CG;
  constexpr int SC = kKv / CG;  // score columns per thread
  constexpr int CW = D / CG;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kRows * DP;
  float* vs = ks + kKv * DP;
  float* ps = vs + kKv * D;

  const int G = H / KH;
  const int BQ = kRows / G;  // q positions per block
  const int n_rows = BQ * G;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / CG;  // owns rows 4*rg .. 4*rg+3
  const int cg = tid % CG;  // owns score and output columns cg + CG*j

  // q tile, scaled in f32 as the TPU kernel does; row r is
  // (position q0 + r / G, head kh*G + r % G), and the G heads of one
  // position lie side by side in memory.
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int qp = q0 + r / G;
    float x = 0.f;
    if (r < n_rows && qp < Sq) {
      const size_t off =
          (((size_t)b * Sq + qp) * H + (size_t)kh * G + r % G) * D + d;
      x = to_f32(q[off]) * scale;
    }
    qs[r * DP + d] = x;
  }

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = q0 + (4 * rg + i) / G;

  float m[4], l[4], acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;
  }

  // kv tiles that intersect this block's causal / window range
  const int n_kv = (Tk + kKv - 1) / kKv;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int hi = causal ? min(q_last / kKv + 1, n_kv) : n_kv;
  int lo = 0;
  if (window >= 0) {
    const int first = q0 - window + 1;  // first key any row here can see
    lo = first > 0 ? first / kKv : 0;
  }

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * kKv;
    __syncthreads();  // every warp is done with the previous k/v tile
    for (int idx = tid; idx < kKv * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const int kp = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kp < Tk) {
        const size_t off = (((size_t)b * Tk + kp) * KH + kh) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[c * DP + d] = kx;
      vs[c * D + d] = vx;
    }
    __syncthreads();

    float s[4][SC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[SC];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * rg + i) * DP + d];
#pragma unroll
      for (int j = 0; j < SC; ++j) kv[j] = ks[(cg + CG * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int kp = k0 + cg + CG * j;
        bool ok = kp < Tk;
        if (causal) ok = ok && kp <= qpos[i];
        if (window >= 0) ok = ok && kp > qpos[i] - window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the CG threads that share a row are CG neighbouring lanes
#pragma unroll
      for (int o = 1; o < CG; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(4 * rg + i) * PP + cg + CG * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 1; o < CG; o <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[i][j] *= alpha;
    }
    // a row's p is written and read by the same warp
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < kKv; ++c) {
      float pv[4], vv[CW];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * rg + i) * PP + c];
#pragma unroll
      for (int j = 0; j < CW; ++j) vv[j] = vs[c * D + cg + CG * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * rg + i;
    if (r >= n_rows || qpos[i] >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* dst =
        o + (((size_t)b * Sq + qpos[i]) * H + (size_t)kh * G + r % G) * D;
#pragma unroll
    for (int j = 0; j < CW; ++j) store(dst + cg + CG * j, acc[i][j] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Tk, int H, int KH, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int BQ = kRows / (H / KH);
  const dim3 grid((Sq + BQ - 1) / BQ, KH, B);
  flash_fwd<T, D><<<grid, 16 * col_groups<D>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Tk, H, KH, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Tk, int H, int KH, int D,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Tk, H, KH, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Tk, H, KH, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Tk, H, KH, causal, window,
                            scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Tk, H, KH, causal, window,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() after the
// launch (0 on success). All tensors are contiguous; `window` < 0 means no
// window; `is_bf16` selects bf16 over f32 for every tensor.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, int B, int Sq, int Tk, int H, int KH,
                              int D, int is_bf16, int causal, int window,
                              float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Tk <= 0 || KH <= 0 || H % KH != 0 ||
      H / KH > kRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Tk, H, KH, D,
                                          causal, window, scale, s);
  return (int)dispatch_d<float>(q, k, v, o, B, Sq, Tk, H, KH, D, causal,
                                window, scale, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
