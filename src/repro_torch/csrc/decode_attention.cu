// Split-K decode attention (one new token against a KV cache) for NVIDIA
// Hopper, written by hand.
//
// Replaces the TPU kernel `decode_attention` -> `_kernel` of
// src/repro/kernels/decode_attention.py, together with the cross-split
// combine that its jit'd wrapper runs in jnp, and computes the same
// function: q (B,H,D), the cache k/v (B,T,KH,D) and lengths (B,) int32 ->
// out (B,H,D) in q's dtype, bf16 or f32; grouped-query attention (each kv
// head serves G = H/KH query rows); q is scaled by D**-0.5 in f32; the
// online-softmax state m, l, acc is f32; key j of row b counts when
// j < lengths[b], and a masked score takes the finite value -1e30, as in
// the TPU kernel.
//
// What bounds it on the H100: every key of the cache is read once and used
// for 4*D flops per query row, so at the serving shapes (G = 2 or 16) the
// function does 1-8 flops per byte and is bound by bytes: the cache,
// 2*B*T*KH*D elements, over the memory rate.
//
// What this design does about it:
// * It reads the cache in the engine's own (B,T,KH,D) layout, 16 bytes a
//   thread, with no transpose: the TPU wrapper's transpose to (B,KH,T,D)
//   would read and write the whole cache once more before the kernel runs.
// * One block owns (batch row, kv head, split of the keys) and its G query
//   rows share every 32-key k/v tile, loaded once into shared memory as
//   f32. The split count is the kernel's own choice (the wrapper picks
//   about two blocks per SM); it changes only the rounding, not the
//   function.
// * A row of length > 0 skips the tiles at and past its length: their
//   weights are exactly 0 (exp(-1e30 - m) with m a real score). A split
//   that lies wholly past the length emits m = -1e30, l = 0, acc = 0, and
//   the combine weighs it by exp(-1e30 - m_g) = 0. A row of length 0 reads
//   every tile: all its scores are -1e30, so each split emits m = -1e30,
//   l = its key count, acc = the sum of its v rows, exactly as the TPU
//   kernel does, and the combine returns the mean of v over all T. The
//   finite mask keeps that free of inf - inf.
// * Both products run as plain f32 FMA on CUDA cores from shared memory
//   (IEEE expf, no fast math, no TF32): a block's tile work is G x 32 x D
//   multiply-adds twice over, far below what the tensor cores would need to
//   matter. A second small kernel combines the splits by their global max,
//   as the TPU wrapper does in jnp, and writes out in q's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kKv = 32;        // keys per k/v tile, one per lane
constexpr int kThreads = 128;  // threads of the split kernel
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // what one block may use on Hopper

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes from global memory -> 16 / sizeof(T) floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

// shared memory of the split kernel, in floats: q and acc [G][D], the k
// tile [kKv][D+1] (padded: lanes read one key each), the v tile [kKv][D],
// scores / probabilities [G][kKv+1], and m, l, alpha [G]
template <int D>
size_t split_smem_floats(int G) {
  return (size_t)2 * G * D + (size_t)kKv * (D + 1) + (size_t)kKv * D +
         (size_t)G * (kKv + 1) + (size_t)3 * G;
}

// One block per (split, kv head, batch row): the online softmax of its G
// query rows over keys [split * split_len, min(+split_len, T)), written as
// partial (m, l, acc) in f32 at ((b*KH + kh)*n_splits + split)*G + g.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_split(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 float* __restrict__ acc_out, int Tk, int H, int KH,
                 int split_len, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int DP = D + 1;
  constexpr int PP = kKv + 1;
  extern __shared__ float smem[];
  const int G = H / KH;
  float* qs = smem;
  float* accs = qs + G * D;
  float* ks = accs + G * D;
  float* vs = ks + kKv * DP;
  float* ps = vs + kKv * D;
  float* ms = ps + G * PP;
  float* ls = ms + G;
  float* alphas = ls + G;

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = lengths[b];
  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, Tk);
  // a row of length <= 0 sees no key, and the finite mask then weighs all
  // of them alike: it reads every tile. Any other row stops at its length.
  const int end = len > 0 ? min(s1, len) : s1;

  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    qs[idx] = to_f32(q[((size_t)b * H + (size_t)kh * G + g) * D + d]) * scale;
    accs[idx] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }

  for (int k0 = s0; k0 < end; k0 += kKv) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kKv * (D / VEC); idx += kThreads) {
      const int c = idx / (D / VEC), d = (idx % (D / VEC)) * VEC;
      const int kp = k0 + c;
      float kx[VEC], vx[VEC];
      if (kp < s1) {
        const size_t off = (((size_t)b * Tk + kp) * KH + kh) * D + d;
        load16(k + off, kx);
        load16(v + off, vx);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kx[j] = vx[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        ks[c * DP + d + j] = kx[j];
        vs[c * D + d + j] = vx[j];
      }
    }
    __syncthreads();

    // scores: (row g, key c) pairs, consecutive lanes on consecutive keys
    for (int idx = tid; idx < G * kKv; idx += kThreads) {
      const int g = idx / kKv, c = idx % kKv;
      const int kp = k0 + c;
      float s = 0.f;
      const float* qg = qs + g * D;
      const float* kc = ks + c * DP;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qg[d], kc[d], s);
      if (kp >= s1)
        s = -INFINITY;  // not a key of this split: weight exactly 0
      else if (kp >= len)
        s = kNegInf;    // the TPU kernel's finite mask
      ps[g * PP + c] = s;
    }
    __syncthreads();

    // online softmax, one warp per row; the tile's first key lies inside
    // the split, so m_new is finite and exp(-inf - m_new) is 0
    for (int g = warp; g < G; g += kWarps) {
      const float s = ps[g * PP + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(s - m_new);
      ps[g * PP + lane] = p;
      float rs = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        ls[g] = ls[g] * alpha + rs;
        ms[g] = m_new;
        alphas[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v; consecutive threads on consecutive columns
    for (int idx = tid; idx < G * D; idx += kThreads) {
      const int g = idx / D, d = idx % D;
      const float* pg = ps + g * PP;
      float a = accs[idx] * alphas[g];
#pragma unroll 8
      for (int c = 0; c < kKv; ++c) a = fmaf(pg[c], vs[c * D + d], a);
      accs[idx] = a;
    }
  }
  __syncthreads();

  const size_t part = (((size_t)b * KH + kh) * gridDim.x + split) * G;
  for (int g = tid; g < G; g += kThreads) {
    m_out[part + g] = ms[g];
    l_out[part + g] = ls[g];
  }
  for (int idx = tid; idx < G * D; idx += kThreads)
    acc_out[part * D + idx] = accs[idx];
}

// One block per (query row g, kv head, batch row), one thread per column:
// the TPU wrapper's combine, renormalising each split's partials by the
// global max and dividing by the combined sum.
template <typename T>
__global__ void decode_combine(const float* __restrict__ m,
                               const float* __restrict__ l,
                               const float* __restrict__ acc,
                               T* __restrict__ out, int H, int KH,
                               int n_splits, int D) {
  const int g = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x;
  const int G = H / KH;
  const size_t base = ((size_t)b * KH + kh) * n_splits * G + g;
  float m_g = m[base];
  for (int s = 1; s < n_splits; ++s) m_g = fmaxf(m_g, m[base + (size_t)s * G]);
  float l_g = 0.f, a = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const size_t i = base + (size_t)s * G;
    const float w = expf(m[i] - m_g);
    l_g += l[i] * w;
    a += acc[i * D + d] * w;
  }
  store(out + ((size_t)b * H + (size_t)kh * G + g) * D + d,
        a / fmaxf(l_g, 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, float* m, float* l, float* acc,
                   void* out, int B, int Tk, int H, int KH, int n_splits,
                   int split_len, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * split_smem_floats<D>(H / KH);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_split<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_split<T, D><<<dim3(n_splits, KH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, m, l, acc, Tk, H, KH, split_len,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<dim3(H / KH, KH, B), D, 0, stream>>>(
      m, l, acc, static_cast<T*>(out), H, KH, n_splits, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const int* lengths, float* m, float* l, float* acc,
                       void* out, int B, int Tk, int H, int KH, int D,
                       int n_splits, int split_len, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, m, l, acc, out, B, Tk, H, KH,
                           n_splits, split_len, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, m, l, acc, out, B, Tk, H, KH,
                           n_splits, split_len, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, m, l, acc, out, B, Tk, H, KH,
                            n_splits, split_len, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, lengths, m, l, acc, out, B, Tk, H, KH,
                            n_splits, split_len, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the split kernel and the combine on `stream` and returns
// cudaGetLastError() after the launches (0 on success). q, k, v and out are
// contiguous, k and v 16-byte aligned; `is_bf16` selects bf16 over f32 for
// all four. m and l are f32 scratch of B*KH*n_splits*G values, acc of that
// times D; split s covers keys [s * split_len, min((s + 1) * split_len, T)),
// and n_splits * split_len >= T.
int repro_decode_attention_fwd(const void* q, const void* k, const void* v,
                               const int* lengths, float* m, float* l,
                               float* acc, void* out, int B, int Tk, int H,
                               int KH, int D, int is_bf16, int n_splits,
                               int split_len, float scale, void* stream) {
  if (B <= 0 || Tk <= 0 || KH <= 0 || H % KH != 0 || n_splits <= 0 ||
      split_len <= 0 || (long long)n_splits * split_len < Tk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, lengths, m, l, acc, out,
                                          B, Tk, H, KH, D, n_splits,
                                          split_len, scale, s);
  return (int)dispatch_d<float>(q, k, v, lengths, m, l, acc, out, B, Tk, H,
                                KH, D, n_splits, split_len, scale, s);
}

const char* repro_decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
