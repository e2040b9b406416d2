// Split-K decode attention (one new token against a KV cache) for NVIDIA
// Hopper, written by hand.
//
// Replaces the TPU kernel `decode_attention` -> `_kernel` of
// src/repro/kernels/decode_attention.py, together with the cross-split
// combine that its jit'd wrapper runs in jnp, and computes the same
// function: q (B,H,D), the cache k/v (B,T,KH,D) and lengths (B,) int32 ->
// out (B,H,D) in q's dtype, bf16 or f32; grouped-query attention (each kv
// head serves G = H/KH query rows); scores scaled by D**-0.5; the
// online-softmax state m, l, acc is f32; key j of row b counts when
// j < lengths[b], and a masked score takes the finite value -1e30, as in
// the TPU kernel.
//
// What bounds it on the H100: every key of the cache is read once and used
// for 4*D flops per query row, so at the serving shapes (G = 2 or 16) the
// function does 1-8 flops per byte and is bound by bytes: the cache,
// 2*B*T*KH*D elements, over the memory rate. A call moves a few MB, so a
// launch and its tail are a large part of the time.
//
// What this design does about it:
// * One launch. The splits of one (batch row, kv head) form a thread-block
//   cluster (at most 16 blocks, as many as the card can co-schedule at the
//   instance's shared memory; the wrapper asks `max_splits`). Each block
//   leaves its partial (m, l, acc) in its own shared memory; after a
//   cluster barrier every block combines a slice of the G x D outputs by
//   reading its peers' partials through distributed shared memory, by
//   their global max as the TPU wrapper does in jnp, and writes out in q's
//   dtype. No scratch in device memory, no state left between calls.
// * It reads the cache in the engine's own (B,T,KH,D) layout, 16 bytes a
//   request, with no transpose.
// * bf16: 32-key k and v tiles stay bf16 in shared memory and arrive by
//   TMA (one thread issues the boxes of a tile, an mbarrier counts its
//   bytes) into a ring of 4 stages (3 at D=256), so the next tiles load
//   while the current one is in use; a warpgroup's own cp.async copies
//   keep too few bytes in flight for a kernel bound by bytes. The tiles
//   take TMA's 128-byte swizzle (64-byte at D=32), so that ldmatrix and the
//   per-key reads meet no bank conflicts.
//   - G > 8 (recurrentgemma-9b's local cache, G=16): both products on
//     the tensor cores with mma.sync m16n8k16 (bf16 in, f32 sums; G is
//     the 16 rows of one tile, where wgmma's 64 would be three quarters
//     empty). S = q . k^T takes the unscaled bf16 q (the products of bf16
//     values are exact in f32) and is scaled after; P . V takes p split
//     into bf16 hi + lo and issues the product twice, as the prefill
//     kernel does (p rounded once breaks the card's bf16 tolerance). Every
//     warp computes the scores of all 32 keys of a tile (the tensor cores
//     have the room) and runs the online softmax on its own fragments, a
//     row's scores in one quad of lanes; the fragments are then P . V's A
//     operand, and each warp owns a quarter of its columns: one block
//     barrier a tile, for the ring. A block holds 16 rows at D=256, up to
//     32 at D=128 and up to 64 below (a wider accumulator would spill), so
//     a wider group takes several row blocks (grid y = kv head x row
//     block), each reading the cache.
//   - G <= 8 (qwen3-0.6b's G=2): f32 FMA on the CUDA cores. Each warp owns
//     8 keys of every tile, 4-8 lanes a key, each lane a slice of D, summed
//     with warp shuffles, so no thread idles behind a 2-row score phase;
//     it keeps its own online softmax over its keys, with no block barrier
//     between scores, softmax and P . V, and the four warps' partials merge
//     once, after the last tile.
// * f32 (the tests' `atol 2e-5` cases): IEEE fmaf on the CUDA cores from
//   f32 tiles, no TF32, no fast math; the block's body is that of the
//   first port, with the cluster combine.
// * A row of length > 0 skips the tiles at and past its length: their
//   weights are exactly 0 (exp(-1e30 - m) with m a real score). A split
//   that lies wholly past the length keeps m = -1e30, l = 0, acc = 0, and
//   the combine weighs it by exp(-1e30 - m_g) = 0. A row of length 0 reads
//   every tile: all its scores are -1e30, so each split has m = -1e30,
//   l = its key count, acc = the sum of its v rows, exactly as the TPU
//   kernel does, and the combine returns the mean of v over all T. Keys of
//   a tile past the split's end score -inf (weight exactly 0); the f32 body
//   zero-fills their k and v, TMA those past T (before T they are the next
//   split's cache entries, weighed 0). The finite mask keeps all of it free
//   of inf - inf.
#include <cooperative_groups.h>
#include <math.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kKv = 32;        // keys per k/v tile
constexpr int kThreads = 128;  // four warps a block
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // what one block may use on Hopper
constexpr int kMaxCluster = 16;      // non-portable cluster limit on Hopper

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// the keys [s0, end) a block reads: a row of length <= 0 sees no key, and
// the finite mask then weighs all of them alike, so it reads every tile
__device__ __forceinline__ int block_end(int len, int s1) {
  return len > 0 ? min(s1, len) : s1;
}

// The combine. Every block of the cluster holds its split's m, l (G rows)
// and acc (G x D, row-major) in shared memory; `wbuf` is (2n + 1) x G
// floats of this block's own; `out` points at the first of the G output
// rows. Block `rank` writes outputs [rank * per, ...) of the row-major
// G x D result (4 at a time), renormalising each split by the global max
// as the TPU wrapper does. Each phase issues its remote reads at once:
// every split's m and l, then every split's four partial sums of an
// output quad as one float4.
template <typename T>
__device__ void cluster_combine(const float* ms, const float* ls,
                                const float* accs, float* wbuf,
                                T* __restrict__ out, int G, int D) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partials are final
  const int n = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  float* w = wbuf;          // [n][G]: each split's m, then its weight
  float* l = wbuf + n * G;  // [n][G]: each split's l
  float* m = l + n * G;     // [G]: the global max
  for (int i = threadIdx.x; i < n * G; i += blockDim.x) {
    const int sp = i / G, g = i % G;
    w[i] = hopper::dsmem_ld(hopper::dsmem_addr(ms + g, sp));
    l[i] = hopper::dsmem_ld(hopper::dsmem_addr(ls + g, sp));
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float m_g = w[g];
    for (int sp = 1; sp < n; ++sp) m_g = fmaxf(m_g, w[sp * G + g]);
    m[g] = m_g;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * G; i += blockDim.x)
    w[i] = expf(w[i] - m[i % G]);
  __syncthreads();
  const int quads = G * D / 4;
  const int per = (quads + n - 1) / n;
  const int hi = min(quads, (rank + 1) * per);
  for (int qd = rank * per + threadIdx.x; qd < hi; qd += blockDim.x) {
    const int g = 4 * qd / D;
    float4 part[kMaxCluster];
#pragma unroll
    for (int sp = 0; sp < kMaxCluster; ++sp)
      part[sp] = sp < n ? hopper::dsmem_ld4(hopper::dsmem_addr(
                              reinterpret_cast<const float4*>(accs) + qd, sp))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    float l_g = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int sp = 0; sp < kMaxCluster; ++sp)
      if (sp < n) {
        const float wt = w[sp * G + g];
        l_g += l[sp * G + g] * wt;
        a0 += part[sp].x * wt;
        a1 += part[sp].y * wt;
        a2 += part[sp].z * wt;
        a3 += part[sp].w * wt;
      }
    const float dn = fmaxf(l_g, 1e-30f);
    T* o = out + 4 * qd;
    store(o, a0 / dn);
    store(o + 1, a1 / dn);
    store(o + 2, a2 / dn);
    store(o + 3, a3 / dn);
  }
  cluster.sync();  // peers keep their shared memory until all have read
}

// the score of a key past the split's end is -inf (weight exactly 0), past
// the row's length the TPU kernel's finite -1e30
__device__ __forceinline__ float mask_score(float s, int kp, int s1,
                                            int len) {
  return kp >= s1 ? -INFINITY : (kp >= len ? kNegInf : s);
}

// ---------------------------------------------------------------------------
// f32: the first port's body, IEEE fmaf from f32 tiles
// ---------------------------------------------------------------------------

// 16 bytes from global memory -> 4 floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

// shared memory, in floats: q and acc [G][D], the k tile [kKv][D+1]
// (padded: lanes read one key each), the v tile [kKv][D], scores /
// probabilities [G][kKv+1] (the combine's weights afterwards), and m, l,
// alpha [G]
template <int D>
size_t f32_smem_bytes(int G) {
  return sizeof(float) * ((size_t)2 * G * D + (size_t)kKv * (D + 1) +
                          (size_t)kKv * D + (size_t)G * (kKv + 1) +
                          (size_t)3 * G);
}

// One block per (split, kv head, batch row): the online softmax of its G
// query rows over keys [split * split_len, min(+split_len, T)), then the
// cluster combine.
template <int D>
__global__ void __launch_bounds__(kThreads)
    decode_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ lengths,
               float* __restrict__ out, int Tk, int H, int KH, int split_len,
               float scale) {
  constexpr int VEC = 4;  // floats per 16-byte load
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
  const int end = block_end(len, s1);

  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    qs[idx] = q[((size_t)b * H + (size_t)kh * G + g) * D + d] * scale;
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
      ps[g * PP + c] = mask_score(s, kp, s1, len);
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
  // the scores' space holds the combine's (2n + 1) G <= 33 G floats
  cluster_combine(ms, ls, accs, ps,
                  out + ((size_t)b * H + (size_t)kh * G) * D, G, D);
}

// ---------------------------------------------------------------------------
// bf16: tiles in flight through a TMA ring
// ---------------------------------------------------------------------------

template <int D>
struct Ring {
  static constexpr int ROWB = D >= 64 ? 128 : 64;  // a swizzled row, bytes
  static constexpr int PPR = ROWB / 16;            // its 16-byte pieces
  static constexpr int CW = ROWB / 2;              // its columns
  static constexpr int NCH = D / CW;               // chunks across D
  static constexpr int STAGES = D >= 256 ? 3 : 4;
  static constexpr int TILE = kKv * D * 2;         // bytes of a k (or v) tile
  static constexpr int STAGE = 2 * TILE;           // k, then v
  static constexpr int BYTES = STAGES * STAGE;
};

// Byte offset of 16-byte piece `p` (of D / 8) of row `r` in a tile of
// `rows` rows, laid out as TMA writes it: CW-column chunks of `rows` rows,
// each row swizzled (128-byte swizzle, 64-byte at D=32), so that ldmatrix
// and the per-key reads meet no bank conflicts.
template <int D>
__device__ __forceinline__ uint32_t piece_off(int r, int p, int rows) {
  using R = Ring<D>;
  return (uint32_t)((p / R::PPR) * rows * R::ROWB) +
         hopper::swizzle<R::ROWB>(r * R::ROWB + (p % R::PPR) * 16);
}

// thread 0: the TMA copies of the k and v tile at keys k0.. into `stage`,
// counted on `bar`; keys past T are zero-filled, keys past the split are
// real cache entries that score -inf
template <int D>
__device__ __forceinline__ void issue_tile(uint8_t* stage,
                                           const CUtensorMap* tk,
                                           const CUtensorMap* tv,
                                           uint64_t* bar, int b, int kh,
                                           int k0) {
  using R = Ring<D>;
  hopper::mbar_arrive_expect_tx(bar, R::STAGE);
#pragma unroll
  for (int ch = 0; ch < R::NCH; ++ch) {
    hopper::tma_load_4d(stage + ch * kKv * R::ROWB, tk, bar, ch * R::CW, kh,
                        k0, b);
    hopper::tma_load_4d(stage + R::TILE + ch * kKv * R::ROWB, tv, bar,
                        ch * R::CW, kh, k0, b);
  }
}

// thread 0, before the block's first barrier: the maps' descriptors on
// their way, the ring's barriers initialised
template <int D>
__device__ __forceinline__ void init_ring(uint64_t* full,
                                          const CUtensorMap* tk,
                                          const CUtensorMap* tv) {
  hopper::prefetch_map(tk);
  hopper::prefetch_map(tv);
  for (int s = 0; s < Ring<D>::STAGES; ++s) hopper::mbar_init(&full[s], 1);
  hopper::mbar_fence_init();
}

// thread 0: the first STAGES tiles in flight
template <int D>
__device__ __forceinline__ void start_ring(uint8_t* ring, uint64_t* full,
                                           const CUtensorMap* tk,
                                           const CUtensorMap* tv, int b,
                                           int kh, int s0, int n_tiles) {
  using R = Ring<D>;
  for (int s = 0; s < R::STAGES && s < n_tiles; ++s)
    issue_tile<D>(ring + s * R::STAGE, tk, tv, &full[s], b, kh,
                  s0 + s * kKv);
}

// the dynamic shared memory, from a 1024-byte boundary (TMA's swizzle)
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
}

// --- G <= 8: CUDA-core FMA, keys spread over the warps -----------------------

constexpr int kFmaMaxG = 8;

template <int D, int GB>
size_t fma_smem_bytes() {
  // ring (after the loop: the four warps' acc [4][GB][D] f32); q and the
  // block's acc [GB][D] f32; each warp's p [4][GB][8] and m, l [4][GB];
  // the block's m, l [GB]; the ring's barriers; slack to align the base
  // to 1024 bytes
  return Ring<D>::BYTES +
         sizeof(float) * ((size_t)2 * GB * D + (size_t)kWarps * GB * 8 +
                          (size_t)2 * kWarps * GB + (size_t)2 * GB) +
         8 * (Ring<D>::STAGES + 1) + 1024;
}

// Each warp owns 8 keys of every tile (4-8 lanes a key, each lane a slice
// of D, summed by shuffles) and keeps its own online softmax over them:
// no block barrier between the scores, the softmax and P . V. The four
// warps' partials merge once, after the last tile. GB >= G rows.
template <int D, int GB>
__global__ void __launch_bounds__(kThreads)
    decode_fma_bf16(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __nv_bfloat16* __restrict__ q,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int Tk, int H, int KH,
                    int split_len, float scale) {
  using R = Ring<D>;
  constexpr int PIECES = D / 8;                 // 16-byte pieces a row
  constexpr int LPK = PIECES < 8 ? PIECES : 8;  // lanes a key
  constexpr int KPS = 32 / LPK;                 // keys a warp step
  constexpr int STEPS = (kKv / kWarps) / KPS;   // steps over a warp's keys
  constexpr int PPL = PIECES / LPK;             // pieces a lane
  constexpr int CPL = D / 32;                   // P.V columns a lane
  static_assert(R::BYTES >= (size_t)kWarps * GB * D * 4, "acc in the ring");
  extern __shared__ uint8_t smem_fma[];
  uint8_t* ring = aligned_smem(smem_fma);
  const int G = H / KH;
  float* qs = reinterpret_cast<float*>(ring + R::BYTES);  // [GB][D]
  float* accs = qs + GB * D;                              // [GB][D]
  float* pw = accs + GB * D;                              // [4][GB][8]
  float* wm = pw + kWarps * GB * 8;                       // [4][GB]
  float* wl = wm + kWarps * GB;                           // [4][GB]
  float* ms = wl + kWarps * GB;                           // [GB]
  float* ls = ms + GB;                                    // [GB]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uintptr_t>(ls + GB + 1) & ~uintptr_t(7));

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = lengths[b];
  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, Tk);
  const int end = block_end(len, s1);
  const int n_tiles = end > s0 ? (end - s0 + kKv - 1) / kKv : 0;

  if (tid == 0) init_ring<D>(full, &tm_k, &tm_v);
  for (int idx = tid; idx < GB * D; idx += kThreads)
    qs[idx] = idx < G * D ? __bfloat162float(
                                q[((size_t)b * H + (size_t)kh * G) * D + idx]) *
                                scale
                          : 0.f;

  // this warp's online softmax (the same in each of its lanes) and this
  // lane's P.V columns lane * CPL ..
  float m[GB], l[GB], acc[GB][CPL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) acc[g][cc] = 0.f;
  }
  float* pmine = pw + warp * GB * 8;
  __syncthreads();  // the barriers are initialised, q is in
  if (tid == 0) start_ring<D>(ring, full, &tm_k, &tm_v, b, kh, s0, n_tiles);

  const int kg = lane / LPK, j = lane % LPK;  // key of the step, its slice
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % R::STAGES;
    hopper::mbar_wait(&full[st], (i / R::STAGES) & 1);
    const int k0 = s0 + i * kKv;
    const uint8_t* kt = ring + st * R::STAGE;
    const uint8_t* vt = kt + R::TILE;

    // scores of the warp's keys 8 warp + KPS step + kg, on all LPK lanes
    float sc[STEPS][GB];
#pragma unroll
    for (int step = 0; step < STEPS; ++step) {
      const int c = warp * (kKv / kWarps) + step * KPS + kg;
      float kf[PPL][8];
#pragma unroll
      for (int u = 0; u < PPL; ++u) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            kt + piece_off<D>(c, j + LPK * u, kKv));
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          kf[u][2 * e] = f.x;
          kf[u][2 * e + 1] = f.y;
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float part[PPL];
#pragma unroll
        for (int u = 0; u < PPL; ++u) {
          const float4* qg = reinterpret_cast<const float4*>(
              qs + g * D + (j + LPK * u) * 8);
          const float4 qa = qg[0], qb = qg[1];
          float x = qa.x * kf[u][0];
          x = fmaf(qa.y, kf[u][1], x);
          x = fmaf(qa.z, kf[u][2], x);
          x = fmaf(qa.w, kf[u][3], x);
          x = fmaf(qb.x, kf[u][4], x);
          x = fmaf(qb.y, kf[u][5], x);
          x = fmaf(qb.z, kf[u][6], x);
          part[u] = fmaf(qb.w, kf[u][7], x);
        }
        float x = part[0];
#pragma unroll
        for (int u = 1; u < PPL; ++u) x += part[u];
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, o);
        sc[step][g] = mask_score(x, k0 + c, s1, len);
      }
    }

    // the warp's softmax over its 8 keys: the steps in registers, the key
    // groups across lanes
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int step = 1; step < STEPS; ++step) mx = fmaxf(mx, sc[step][g]);
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int step = 0; step < STEPS; ++step) {
        const float p = expf(sc[step][g] - m_new);
        if (j == 0) pmine[g * 8 + step * KPS + kg] = p;
        rs += p;
      }
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[g] = l[g] * alpha + rs;
      m[g] = m_new;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) acc[g][cc] *= alpha;
    }
    __syncwarp();

    // acc += p . v over the warp's 8 keys, this lane's CPL columns
#pragma unroll
    for (int c = 0; c < kKv / kWarps; ++c) {
      const int key = warp * (kKv / kWarps) + c;
      float vf[CPL];
      const int col = lane * CPL;
      const uint8_t* vrow = vt + piece_off<D>(key, col / 8, kKv) + (col % 8) * 2;
      if constexpr (CPL == 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(vrow);
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          vf[2 * e] = f.x;
          vf[2 * e + 1] = f.y;
        }
      } else if constexpr (CPL == 4) {
        const uint2 raw = *reinterpret_cast<const uint2*>(vrow);
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          vf[2 * e] = f.x;
          vf[2 * e + 1] = f.y;
        }
      } else if constexpr (CPL == 2) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vrow));
        vf[0] = f.x;
        vf[1] = f.y;
      } else {
        vf[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(vrow));
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float p = pmine[g * 8 + c];
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) acc[g][cc] = fmaf(p, vf[cc], acc[g][cc]);
      }
    }
    __syncthreads();  // every warp is done with the stage
    if (tid == 0 && i + R::STAGES < n_tiles)
      issue_tile<D>(ring + st * R::STAGE, &tm_k, &tm_v, &full[st], b, kh,
                    s0 + (i + R::STAGES) * kKv);
  }

  // the four warps' partials merge by their max into the block's m, l, acc
  __syncthreads();  // the ring is free: it takes the warps' acc
  float* wacc = reinterpret_cast<float*>(ring);  // [4][GB][D]
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (lane == 0) {
      wm[warp * GB + g] = m[g];
      wl[warp * GB + g] = l[g];
    }
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
      wacc[(warp * GB + g) * D + lane * CPL + cc] = acc[g][cc];
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    float mb = wm[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mb = fmaxf(mb, wm[w * GB + g]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(wm[w * GB + g] - mb);
      lb += wl[w * GB + g] * wt;
      ab += wacc[(w * GB + g) * D + idx % D] * wt;
    }
    accs[idx] = ab;
    if (idx % D == 0) {
      ms[g] = mb;
      ls[g] = lb;
    }
  }
  // the ring, free again, holds the combine's (2n + 1) G floats
  cluster_combine(ms, ls, accs, reinterpret_cast<float*>(ring),
                  out + ((size_t)b * H + (size_t)kh * G) * D, G, D);
}

// --- G >= 9: mma.sync on the tensor cores -----------------------------------

template <int D, int MT>
size_t mma_smem_bytes() {
  // ring; q [16 MT][D] bf16 (swizzled); m, l [16 MT]; the combine's
  // (2n + 1) x 16 MT floats; the ring's barriers; slack to align the base
  // to 1024 bytes. The combine's acc [G][D] f32 reuses the ring.
  return Ring<D>::BYTES + (size_t)16 * MT * D * 2 +
         sizeof(float) * (2 + 2 * kMaxCluster + 1) * 16 * MT +
         8 * (Ring<D>::STAGES + 1) + 1024;
}

template <int D, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    decode_mma_bf16(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __nv_bfloat16* __restrict__ q,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int Tk, int H, int KH,
                    int split_len, float scale) {
  using R = Ring<D>;
  constexpr int ROWS = 16 * MT;
  constexpr int NK = kKv / 8;     // 8-key tiles of a k/v tile
  constexpr int CW = D / kWarps;  // P.V columns a warp
  constexpr int NT = CW / 8;      // its 8-column tiles
  static_assert(R::BYTES >= (size_t)ROWS * D * 4, "acc fits in the ring");
  extern __shared__ uint8_t smem_mma[];
  // a group wider than ROWS is cut into blocks of ROWS query rows (grid y
  // = kv head x row block); this block owns rows row0 .. row0 + G - 1
  const int Gfull = H / KH;
  const int nrb = (Gfull + ROWS - 1) / ROWS;
  const int row0 = (blockIdx.y % nrb) * ROWS;
  const int G = min(ROWS, Gfull - row0);
  uint8_t* ring = aligned_smem(smem_mma);
  uint8_t* qs = ring + R::BYTES;
  float* ms = reinterpret_cast<float*>(qs + ROWS * D * 2);
  float* ls = ms + ROWS;
  float* wbuf = ls + ROWS;  // [2n + 1][ROWS]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      wbuf + (2 * kMaxCluster + 1) * ROWS);

  const int split = blockIdx.x, kh = blockIdx.y / nrb, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row and column pair
  const size_t row_base = (size_t)b * H + (size_t)kh * Gfull + row0;
  const int len = lengths[b];
  const int s0 = split * split_len;
  const int s1 = min(s0 + split_len, Tk);
  const int end = block_end(len, s1);
  const int n_tiles = end > s0 ? (end - s0 + kKv - 1) / kKv : 0;

  if (tid == 0) init_ring<D>(full, &tm_k, &tm_v);
  // q rows g < G (zero past G), swizzled like the k rows
  for (int idx = tid; idx < ROWS * D / 8; idx += kThreads) {
    const int r = idx / (D / 8), p = idx % (D / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < G)
      val = *reinterpret_cast<const uint4*>(q + (row_base + r) * D + p * 8);
    *reinterpret_cast<uint4*>(qs + piece_off<D>(r, p, ROWS)) = val;
  }

  // every warp keeps the online-softmax state of every row (rows
  // 16 mt + lane/4 and + 8), the same in all four; acc holds its columns
  float m[MT][2], l[MT][2], acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = kNegInf;
      l[mt][h] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }

  __syncthreads();  // the barriers are initialised, q is in
  if (tid == 0) start_ring<D>(ring, full, &tm_k, &tm_v, b, kh, s0, n_tiles);
  const uint32_t q_base = hopper::smem_u32(qs);
  const int lm = lane / 8;  // the ldmatrix matrix this lane addresses
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % R::STAGES;
    hopper::mbar_wait(&full[st], (i / R::STAGES) & 1);
    const int k0 = s0 + i * kKv;
    const uint32_t k_base = hopper::smem_u32(ring + st * R::STAGE);
    const uint32_t v_base = k_base + R::TILE;

    // S = q . k^T over all 32 keys of the tile in every warp (the tensor
    // cores have the room), so the softmax below needs no other warp
    float sc[MT][NK][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nk = 0; nk < NK; ++nk)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][nk][e] = 0.f;
#pragma unroll
    for (int kp = 0; kp < D / 32; ++kp) {
      uint32_t kb[NK][4];  // two k-steps of each 8-key tile
#pragma unroll
      for (int nk = 0; nk < NK; ++nk)
        hopper::ldmatrix_x4(kb[nk], k_base + piece_off<D>(8 * nk + lane % 8,
                                                          4 * kp + lm, kKv));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t a[4];
          const int row = mt * 16 + (lm & 1) * 8 + lane % 8;
          hopper::ldmatrix_x4(
              a, q_base + piece_off<D>(row, 4 * kp + 2 * half + (lm >> 1),
                                       ROWS));
#pragma unroll
          for (int nk = 0; nk < NK; ++nk)
            hopper::mma_bf16_16816(sc[mt][nk], a, kb[nk][2 * half],
                                   kb[nk][2 * half + 1]);
        }
    }

    // online softmax on the fragments: a row's 32 scores lie in the 4
    // lanes of a quad, 8 each
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int nk = 0; nk < NK; ++nk)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + 8 * nk + 2 * tq + e;
            float& x = sc[mt][nk][2 * h + e];
            x = mask_score(x * scale, kp, s1, len);
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][h], mx);
        const float alpha = expf(m[mt][h] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int nk = 0; nk < NK; ++nk)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[mt][nk][2 * h + e];
            x = expf(x - m_new);
            rs += x;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[mt][h] = l[mt][h] * alpha + rs;
        m[mt][h] = m_new;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[mt][nt][2 * h] *= alpha;
          acc[mt][nt][2 * h + 1] *= alpha;
        }
      }

    // acc += p_hi . V + p_lo . V on this warp's columns; the score
    // fragments of two 8-key tiles are the A fragment of 16 keys
#pragma unroll
    for (int kk = 0; kk < kKv / 16; ++kk) {
      uint32_t vb[NT][2];
      if constexpr (NT >= 2) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r4[4];
          const int key = kk * 16 + (lm & 1) * 8 + lane % 8;
          const int col0 = warp * CW + np * 16 + (lm >> 1) * 8;
          hopper::ldmatrix_x4_trans(r4,
                                    v_base + piece_off<D>(key, col0 / 8, kKv));
          vb[2 * np][0] = r4[0];
          vb[2 * np][1] = r4[1];
          vb[2 * np + 1][0] = r4[2];
          vb[2 * np + 1][1] = r4[3];
        }
      } else {
        uint32_t r2[2];
        const int key = kk * 16 + (lm & 1) * 8 + lane % 8;
        hopper::ldmatrix_x2_trans(
            r2, v_base + piece_off<D>(key, warp * CW / 8, kKv));
        vb[0][0] = r2[0];
        vb[0][1] = r2[1];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t hi[4], lo[4];
        hopper::split_bf16x2(sc[mt][2 * kk][0], sc[mt][2 * kk][1], hi[0],
                             lo[0]);
        hopper::split_bf16x2(sc[mt][2 * kk][2], sc[mt][2 * kk][3], hi[1],
                             lo[1]);
        hopper::split_bf16x2(sc[mt][2 * kk + 1][0], sc[mt][2 * kk + 1][1],
                             hi[2], lo[2]);
        hopper::split_bf16x2(sc[mt][2 * kk + 1][2], sc[mt][2 * kk + 1][3],
                             hi[3], lo[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          hopper::mma_bf16_16816(acc[mt][nt], hi, vb[nt][0], vb[nt][1]);
          hopper::mma_bf16_16816(acc[mt][nt], lo, vb[nt][0], vb[nt][1]);
        }
      }
    }
    __syncthreads();  // every warp is done with the stage
    if (tid == 0 && i + R::STAGES < n_tiles)
      issue_tile<D>(ring + st * R::STAGE, &tm_k, &tm_v, &full[st], b, kh,
                    s0 + (i + R::STAGES) * kKv);
  }
  __syncthreads();  // the ring is free: it takes the combine's acc [G][D]
  float* accs = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + gq + 8 * h;
      if (row >= G) continue;
      if (warp == 0 && tq == 0) {
        ms[row] = m[mt][h];
        ls[row] = l[mt][h];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(accs + row * D + warp * CW + nt * 8 +
                                   2 * tq) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    }
  cluster_combine(ms, ls, accs, wbuf, out + row_base * D, G, D);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Raises the instance's dynamic shared memory limit to what a block may
// have (its launches differ in G, so in shared memory) and allows clusters
// past the portable 8, once per device (the attributes hold until the
// process ends); `done` is the instance's own flag word, one bit per device
// ordinal below 32.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (__atomic_load_n(&done, __ATOMIC_ACQUIRE) & bit))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && bit)
    __atomic_fetch_or(&done, bit, __ATOMIC_RELEASE);
  return err;
}

struct Call {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  int B, Tk, H, KH, n_splits, split_len;
  float scale;
  cudaStream_t stream;
  int row_blocks;  // blocks a (batch row, kv head, split) along grid y
};

// Launches `kernel` over (n_splits, KH x row blocks, B) blocks, the
// n_splits of one (batch row, kv head, row block) as one cluster, through
// `launch(cfg)`; with `c.n_splits` <= 0 it returns instead the largest
// cluster (<= kMaxCluster) that the card can schedule at this shared
// memory, or a negative CUDA error.
template <typename Kernel, typename Launch>
int run(Kernel kernel, size_t smem, unsigned& done, const Call& c,
        Launch launch) {
  if (smem > kMaxSmem)
    return c.n_splits > 0 ? (int)cudaErrorInvalidValue
                          : -(int)cudaErrorInvalidValue;
  cudaError_t err = prepare(kernel, done);
  if (err != cudaSuccess) return c.n_splits > 0 ? (int)err : -(int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (c.n_splits <= 0) {
    for (int n = kMaxCluster; n > 1; n /= 2) {
      attr[0].val.clusterDim.x = n;
      cfg.gridDim = dim3(n, 1, 1);
      int clusters = 0;
      if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) ==
              cudaSuccess &&
          clusters > 0)
        return n;
      cudaGetLastError();  // a size the card refuses is not an error here
    }
    return 1;
  }
  if (c.n_splits > kMaxCluster) return (int)cudaErrorInvalidValue;
  attr[0].val.clusterDim.x = c.n_splits;
  cfg.gridDim = dim3(c.n_splits, c.KH * c.row_blocks, c.B);
  cfg.stream = c.stream;
  err = launch(cfg);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int D, typename Kernel>
int run_bf16(Kernel kernel, size_t smem, unsigned& done, const Call& c) {
  using R = Ring<D>;
  // k and v as the 4-D tensors (B, T, KH, D) they are, in boxes of 32 keys
  // x CW columns of one kv head: no box crosses into the next batch row,
  // and keys past T are zero-filled
  CUtensorMap tm_k{}, tm_v{};
  if (c.n_splits > 0) {
    const uint64_t dims[4] = {(uint64_t)D, (uint64_t)c.KH, (uint64_t)c.Tk,
                              (uint64_t)c.B};
    const uint32_t box[4] = {(uint32_t)R::CW, 1, (uint32_t)kKv, 1};
    cudaError_t err = hopper::make_map_4d(&tm_k, c.k, dims, box, R::ROWB);
    if (err == cudaSuccess)
      err = hopper::make_map_4d(&tm_v, c.v, dims, box, R::ROWB);
    if (err != cudaSuccess) return (int)err;
  }
  return run(kernel, smem, done, c, [&](const cudaLaunchConfig_t& cfg) {
    return cudaLaunchKernelEx(
        &cfg, kernel, tm_k, tm_v, static_cast<const __nv_bfloat16*>(c.q),
        c.lengths, static_cast<__nv_bfloat16*>(c.out), c.Tk, c.H, c.KH,
        c.split_len, c.scale);
  });
}

template <int D>
int dispatch_bf16(Call c) {
  const int G = c.H / c.KH;
  if (G <= 1) {
    static unsigned done = 0;
    return run_bf16<D>(decode_fma_bf16<D, 1>, fma_smem_bytes<D, 1>(), done,
                       c);
  }
  if (G <= 2) {
    static unsigned done = 0;
    return run_bf16<D>(decode_fma_bf16<D, 2>, fma_smem_bytes<D, 2>(), done,
                       c);
  }
  if (G <= 4) {
    static unsigned done = 0;
    return run_bf16<D>(decode_fma_bf16<D, 4>, fma_smem_bytes<D, 4>(), done,
                       c);
  }
  if (G <= kFmaMaxG) {
    static unsigned done = 0;
    return run_bf16<D>(decode_fma_bf16<D, 8>, fma_smem_bytes<D, 8>(), done,
                       c);
  }
  // a block holds 16 rows at D=256, up to 32 at D=128 and up to 64 below:
  // wider accumulators do not fit the registers, so a wider group takes
  // several row blocks in the same launch
  if (G <= 16 || (D == 256 && G <= 64)) {
    static unsigned done = 0;
    c.row_blocks = (G + 15) / 16;
    return run_bf16<D>(decode_mma_bf16<D, 1>, mma_smem_bytes<D, 1>(), done,
                       c);
  }
  if constexpr (D <= 128) {
    if (G <= 32 || (D == 128 && G <= 64)) {
      static unsigned done = 0;
      c.row_blocks = (G + 31) / 32;
      return run_bf16<D>(decode_mma_bf16<D, 2>, mma_smem_bytes<D, 2>(), done,
                         c);
    }
  }
  if constexpr (D <= 64) {
    if (G <= 64) {
      static unsigned done = 0;
      return run_bf16<D>(decode_mma_bf16<D, 4>, mma_smem_bytes<D, 4>(), done,
                         c);
    }
  }
  return c.n_splits > 0 ? (int)cudaErrorInvalidValue
                        : -(int)cudaErrorInvalidValue;
}

template <int D>
int dispatch(const Call& c, int is_bf16) {
  if (is_bf16) return dispatch_bf16<D>(c);
  static unsigned done = 0;
  return run(decode_f32<D>, f32_smem_bytes<D>(c.H / c.KH), done, c,
             [&](const cudaLaunchConfig_t& cfg) {
               return cudaLaunchKernelEx(
                   &cfg, decode_f32<D>, static_cast<const float*>(c.q),
                   static_cast<const float*>(c.k),
                   static_cast<const float*>(c.v), c.lengths,
                   static_cast<float*>(c.out), c.Tk, c.H, c.KH, c.split_len,
                   c.scale);
             });
}

int dispatch_d(const Call& c, int D, int is_bf16) {
  switch (D) {
    case 32:
      return dispatch<32>(c, is_bf16);
    case 64:
      return dispatch<64>(c, is_bf16);
    case 128:
      return dispatch<128>(c, is_bf16);
    case 256:
      return dispatch<256>(c, is_bf16);
    default:
      return c.n_splits > 0 ? (int)cudaErrorInvalidValue
                            : -(int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (one launch: the n_splits blocks of each
// (batch row, kv head) form a cluster) and returns cudaGetLastError() after
// it (0 on success). q, k, v and out are contiguous and 16-byte aligned;
// `is_bf16` selects bf16 over f32 for all four. Split s covers keys
// [s * split_len, min((s + 1) * split_len, T)); n_splits * split_len >= T
// and n_splits <= repro_decode_attention_max_splits(...).
int repro_decode_attention_fwd(const void* q, const void* k, const void* v,
                               const int* lengths, void* out, int B, int Tk,
                               int H, int KH, int D, int is_bf16,
                               int n_splits, int split_len, float scale,
                               void* stream) {
  if (B <= 0 || Tk <= 0 || KH <= 0 || H % KH != 0 || n_splits <= 0 ||
      split_len <= 0 || (long long)n_splits * split_len < Tk)
    return (int)cudaErrorInvalidValue;
  const Call c{q, k, v, lengths, out, B, Tk, H, KH, n_splits, split_len,
               scale, static_cast<cudaStream_t>(stream), 1};
  return dispatch_d(c, D, is_bf16);
}

// The most splits (blocks in one cluster, a power of two <= 16) that the
// card can co-schedule for this instance (G = H / KH, D, dtype); a
// negative value is a CUDA error, negated.
int repro_decode_attention_max_splits(int H, int KH, int D, int is_bf16) {
  if (KH <= 0 || H % KH != 0) return -(int)cudaErrorInvalidValue;
  const Call c{nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, H, KH, 0,
               1, 1.f, nullptr, 1};
  return dispatch_d(c, D, is_bf16);
}

const char* repro_decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
