// Flash attention forward (prefill) for NVIDIA Hopper, written by hand.
//
// Replaces the TPU kernel `flash_attention` -> `_kernel` of
// src/repro/kernels/flash_attention.py and computes the same function:
// q (B,Sq,H,D), k/v (B,T,KH,D), bf16 or f32, out (B,Sq,H,D) in q's dtype;
// grouped-query attention (each kv head serves G = H/KH query heads, folded
// into the rows as (position, group)); scores scaled by D**-0.5; the
// online-softmax state m, l, acc is f32; causal and sliding-window masks come
// from absolute positions (q position p sees key j when j <= p and
// j > p - window); kv tiles outside [lo, hi) for a block are skipped. Masked
// scores take the finite value -1e30, as in the TPU kernel: a tile that is
// fully masked for a row gives p = 1 there until a tile with a real score
// resets the row through alpha = exp(m - m_new) = 0, so no inf - inf ever
// makes a NaN.
//
// What bounds it on the H100: at the prefill shapes of the serving path
// (Sq = T <= 4096, D = 96, 128 or 256) a block reads its q tile once and streams
// the k/v tiles of its range, so the bytes are ~ (q + k + v + o) and the work
// is ~4*D flops per unmasked (query, key) pair: the function is bound by
// operations, at the bf16 tensor-core rate.
//
// bf16 (the serving path): flash_fwd_wgmma, on the tensor cores.
//   * A block is one consumer warpgroup that owns 64 rows (64 / G positions
//     x G heads of one kv head) and one producer warp. The producer streams
//     64-key k and v tiles through TMA into a two-stage ring in shared memory
//     (one mbarrier per tile that counts the bytes, one per stage that the
//     consumer's warps release); k and v are described as the 4-D tensors
//     (B, T, KH, D) they are, so TMA zero-fills past T and no box crosses
//     into the next batch row. q is read once, with 16-byte loads.
//   * Rows of q, k and v are cut into swizzled chunks: 64 columns (128-byte
//     swizzle) where 64 divides D, else 32 columns (64-byte swizzle). D=96
//     (phi-3-vision) is 1.5 128-byte atoms wide, so it takes three 32-column
//     chunks, TMA boxes of {32, 1, 64, 1} and three N=32 P.V products a
//     k-step: no column is padded, so no work is wasted. (The other way, two
//     64-column chunks with TMA zero-filling columns 96-127, would cost a
//     third more products and need zero-filled q loads.)
//   * S = q . k^T is a wgmma from shared memory (both K-major) on the
//     unscaled bf16 q; the f32 scores are scaled after the product (q.k of
//     bf16 values is exact in f32 products).
//   * The softmax runs on the accumulator's own fragment: a thread holds two
//     rows, the 4 lanes of a quad share them (shuffles 1 and 2). Only tiles
//     that cross the diagonal, the window's edge or T are masked.
//   * O += P . V is a wgmma with P from registers (the accumulator fragment
//     is the A fragment) and V MN-major from shared memory. P is split:
//     p_hi = bf16(p), p_lo = bf16(p - p_hi), two products into the one f32
//     accumulator. P rounded once to bf16 puts the output up to 3.4x the
//     bf16 tolerance away from the f32 computation (at early positions,
//     where an output near 0 is a difference of a few large p.v terms);
//     split, it stays within 0.89 of it. l sums the unrounded f32 p.
//   * Registers: at D=256 the 64 x 256 f32 accumulator is 128 a thread, and
//     160 KB of shared memory leave one block per SM; at D <= 128 two blocks
//     share an SM, so one's softmax overlaps the other's products (D=96:
//     61 KB a block).
//   * Blocks of the longest causal range launch first.
// f32: flash_fwd, IEEE fmaf on the CUDA cores (no TF32, by design: the f32
//   cases hold 2e-5). One block owns 64 rows and streams 64-key tiles of k
//   and v through shared memory as f32; the block's threads form 16 row
//   groups x CG column groups, each thread a 4 x 64/CG score micro-tile and
//   a 4 x D/CG output micro-tile, on padded strides. D <= 128 runs 128
//   threads (CG = 8; D = 96: 12 output columns a thread), D = 256 256
//   threads (CG = 16).
// Ragged edges (Sq or T not a multiple of a tile) are masked, not asserted
// away.
#include "hopper.cuh"

namespace {

constexpr int kRows = 64;      // q rows per block: (position, group) pairs
constexpr int kKv = 64;        // keys per k/v tile
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA
// ---------------------------------------------------------------------------

// column groups per row group: D <= 128 takes 8 (128 threads), D = 256 16
// (256 threads)
template <int D>
constexpr int col_groups() { return D > 128 ? 16 : 8; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

template <int D>
struct Tc {
  // columns of one swizzled chunk: 64, or 32 where 64 does not divide D
  // (D = 32, and D = 96 in three chunks)
  static constexpr int CW = D % 64 == 0 ? 64 : 32;
  static constexpr int ROWB = CW * 2;         // its row: 128 (or 64) bytes
  static constexpr int NCH = D / CW;          // chunks across a row
  static_assert(NCH * CW == D, "a row is a whole number of chunks");
  static constexpr int Q_CHUNK = kRows * ROWB;
  static constexpr int KV_CHUNK = kKv * ROWB;
  static constexpr int KV_TILE = NCH * KV_CHUNK;  // one k or v tile, bytes
  static constexpr int STAGES = 2;
  static constexpr int SMEM_Q = 0;
  static constexpr int SMEM_K = NCH * Q_CHUNK;
  static constexpr int SMEM_V = SMEM_K + STAGES * KV_TILE;
  static constexpr int SMEM_BAR = SMEM_V + STAGES * KV_TILE;
  // + 3 barriers a stage, + slack to align the base to 1024 bytes
  static constexpr int SMEM = SMEM_BAR + 3 * STAGES * 8 + 1024;
  static constexpr int THREADS = 128 + 32;  // consumer warpgroup + producer
  static constexpr int MIN_BLOCKS = D > 128 ? 1 : 2;
};

template <int D>
__global__ void __launch_bounds__(Tc<D>::THREADS, Tc<D>::MIN_BLOCKS)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __nv_bfloat16* __restrict__ q,
                    __nv_bfloat16* __restrict__ o, int Sq, int Tk, int H,
                    int KH, int causal, int window, float scale_log2) {
  using C = Tc<D>;
  constexpr int PN = C::CW;         // columns of each P.V product
  constexpr int NF = PN / 2;        // its accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) &
                              1023);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + C::SMEM_BAR);
  uint64_t* full_v = full_k + C::STAGES;
  uint64_t* empty = full_v + C::STAGES;

  const int G = H / KH;
  const int BQ = kRows / G;  // q positions per block
  const int n_rows = BQ * G;
  const int kh = blockIdx.x % KH;
  const int b = blockIdx.x / KH;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest range first
  const int tid = threadIdx.x;

  // kv tiles that intersect this block's causal / window range
  const int n_kv = (Tk + kKv - 1) / kKv;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int hi = causal ? min(q_last / kKv + 1, n_kv) : n_kv;
  int lo = 0;
  if (window >= 0) {
    const int first = q0 - window + 1;  // first key any row here can see
    lo = first > 0 ? first / kKv : 0;
  }
  const int n_tiles = max(hi - lo, 0);

  if (tid == 128) {
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty[s], 4);  // lane 0 of each consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {
    // producer: one thread keeps the ring full
    if (tid == 128) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES;
        const uint32_t ph = (i / C::STAGES) & 1;
        const int k0 = (lo + i) * kKv;
        hopper::mbar_wait(&empty[s], ph ^ 1);
        uint8_t* kt = smem + C::SMEM_K + s * C::KV_TILE;
        uint8_t* vt = smem + C::SMEM_V + s * C::KV_TILE;
        hopper::mbar_arrive_expect_tx(&full_k[s], C::KV_TILE);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c)
          hopper::tma_load_4d(kt + c * C::KV_CHUNK, &tm_k, &full_k[s],
                              c * C::CW, kh, k0, b);
        hopper::mbar_arrive_expect_tx(&full_v[s], C::KV_TILE);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c)
          hopper::tma_load_4d(vt + c * C::KV_CHUNK, &tm_v, &full_v[s],
                              c * C::CW, kh, k0, b);
      }
    }
    return;
  }

  // consumer warpgroup. q tile: row r is (position q0 + r / G, head
  // kh*G + r % G); the G heads of one position lie side by side in memory.
  constexpr int PIECES = D / 8;  // 16-byte pieces of a row
  for (int idx = tid; idx < kRows * PIECES; idx += 128) {
    const int r = idx / PIECES, pc = idx % PIECES;
    const int qp = q0 + r / G;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n_rows && qp < Sq)
      val = __ldg(reinterpret_cast<const uint4*>(
          q + (((size_t)b * Sq + qp) * H + (size_t)kh * G + r % G) * D +
          pc * 8));
    const int ch = pc / (C::CW / 8), in_row = pc % (C::CW / 8);
    *reinterpret_cast<uint4*>(
        smem + C::SMEM_Q + ch * C::Q_CHUNK +
        hopper::swizzle<C::ROWB>(r * C::ROWB + in_row * 16)) = val;
  }
  hopper::fence_proxy_async();
  asm volatile("bar.sync 1, 128;" ::: "memory");

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;  // rows r0 and r0 + 8
  const int qp0 = q0 + r0 / G, qp1 = q0 + (r0 + 8) / G;
  const uint32_t q_base = hopper::smem_u32(smem + C::SMEM_Q);
  const uint32_t k_base = hopper::smem_u32(smem + C::SMEM_K);
  const uint32_t v_base = hopper::smem_u32(smem + C::SMEM_V);

  float acc[C::NCH][NF];
#pragma unroll
  for (int c = 0; c < C::NCH; ++c)
#pragma unroll
    for (int e = 0; e < NF; ++e) acc[c][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's columns; summed over the quad
  float sc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % C::STAGES;
    const uint32_t ph = (i / C::STAGES) & 1;
    const int k0 = (lo + i) * kKv;

    // S = q . k^T: D/16 k-steps of 16 columns
    hopper::mbar_wait(&full_k[s], ph);
    __syncwarp();
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const uint32_t chunk = j / (C::CW / 16);
      const uint32_t off = (j % (C::CW / 16)) * 32;  // inside the row
      const uint64_t da = hopper::wgmma_desc(
          q_base + chunk * C::Q_CHUNK + off, 16, 8 * C::ROWB, C::ROWB);
      const uint64_t db = hopper::wgmma_desc(
          k_base + s * C::KV_TILE + chunk * C::KV_CHUNK + off, 16,
          8 * C::ROWB, C::ROWB);
      hopper::wgmma_m64n64k16_ss(sc, da, db, j > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // softmax on the fragment: element e is row r0 + 8 * ((e / 2) % 2),
    // column 8 * (e / 4) + 2 * (lane % 4) + e % 2
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] *= scale_log2;
    const bool need_mask =
        k0 + kKv > Tk || (causal && k0 + kKv - 1 > q0) ||
        (window >= 0 && k0 <= q0 + BQ - 1 - window);
    if (need_mask) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kp = k0 + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
        const int qp = (e / 2) % 2 ? qp1 : qp0;
        bool ok = kp < Tk;
        if (causal) ok = ok && kp <= qp;
        if (window >= 0) ok = ok && kp > qp - window;
        if (!ok) sc[e] = kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < 32; ++e)
      mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], sc[e]);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
    // p, split into bf16 hi + lo A fragments; k-step kk takes columns
    // 16kk..16kk+15: registers (e, e+1) for e = 8kk + 2j, j = 0..3
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 8 * kk + 2 * j, h = j % 2;
        const float x0 = exp2f(sc[e] - m[h]);
        const float x1 = exp2f(sc[e + 1] - m[h]);
        l[h] += x0 + x1;
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(x0, x1);
        const float2 back = __bfloat1622float2(hi2);
        const __nv_bfloat162 lo2 =
            __floats2bfloat162_rn(x0 - back.x, x1 - back.y);
        p_hi[kk][j] = *reinterpret_cast<const uint32_t*>(&hi2);
        p_lo[kk][j] = *reinterpret_cast<const uint32_t*>(&lo2);
      }
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
#pragma unroll
      for (int e = 0; e < NF; ++e) acc[c][e] *= alpha[(e / 2) % 2];

    // O += p_hi . V + p_lo . V
    hopper::mbar_wait(&full_v[s], ph);
    __syncwarp();
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = hopper::wgmma_desc(
            v_base + s * C::KV_TILE + c * C::KV_CHUNK + kk * 16 * C::ROWB,
            C::KV_CHUNK, 8 * C::ROWB, C::ROWB);
        hopper::wgmma_rs_mn<PN>(acc[c], p_hi[kk], dv);
        hopper::wgmma_rs_mn<PN>(acc[c], p_lo[kk], dv);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) hopper::fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hopper::fence_regs(p_hi[kk]);
      hopper::fence_regs(p_lo[kk]);
    }
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // this warp is done
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int qp = h ? qp1 : qp0;
    if (r >= n_rows || qp >= Sq) continue;
    const float den = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* dst =
        o + (((size_t)b * Sq + qp) * H + (size_t)kh * G + r % G) * D;
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
#pragma unroll
      for (int j = 0; j < NF / 4; ++j) {
        const int col = c * PN + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(acc[c][4 * j + 2 * h] / den,
                                  acc[c][4 * j + 2 * h + 1] / den);
      }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Tk, int H, int KH, int causal,
                       int window, float scale, cudaStream_t stream) {
  static unsigned attr_set = 0;
  const size_t smem = smem_bytes<D>();
  cudaError_t err =
      hopper::set_smem_once(flash_fwd<float, D>, (int)smem, attr_set);
  if (err != cudaSuccess) return err;
  const int BQ = kRows / (H / KH);
  const dim3 grid((Sq + BQ - 1) / BQ, KH, B);
  flash_fwd<float, D><<<grid, 16 * col_groups<D>(), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Tk, H, KH,
      causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Tk, int H, int KH, int causal,
                        int window, float scale, cudaStream_t stream) {
  using C = Tc<D>;
  // 16-byte loads of q, TMA boxes of k and v
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
      16)
    return cudaErrorInvalidValue;
  const int BQ = kRows / (H / KH);
  const int n_qt = (Sq + BQ - 1) / BQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)KH, (uint64_t)Tk,
                            (uint64_t)B};
  const uint32_t box[4] = {(uint32_t)C::CW, 1, (uint32_t)kKv, 1};
  CUtensorMap tm_k, tm_v;
  cudaError_t err = hopper::make_map_4d(&tm_k, k, dims, box, C::ROWB);
  if (err == cudaSuccess)
    err = hopper::make_map_4d(&tm_v, v, dims, box, C::ROWB);
  if (err != cudaSuccess) return err;
  static unsigned attr_set = 0;
  err = hopper::set_smem_once(flash_fwd_wgmma<D>, C::SMEM, attr_set);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma<D><<<dim3(KH * B, n_qt), C::THREADS, C::SMEM, stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), Sq, Tk, H, KH, causal, window,
      scale * 1.4426950408889634f);  // exp(x) = exp2(x * log2(e))
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Tk, int H, int KH, int is_bf16,
                   int causal, int window, float scale, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(q, k, v, o, B, Sq, Tk, H, KH, causal,
                                  window, scale, stream)
                 : launch_f32<D>(q, k, v, o, B, Sq, Tk, H, KH, causal,
                                 window, scale, stream);
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
  switch (D) {
    case 32:
      return (int)launch<32>(q, k, v, o, B, Sq, Tk, H, KH, is_bf16, causal,
                             window, scale, s);
    case 64:
      return (int)launch<64>(q, k, v, o, B, Sq, Tk, H, KH, is_bf16, causal,
                             window, scale, s);
    case 96:
      return (int)launch<96>(q, k, v, o, B, Sq, Tk, H, KH, is_bf16, causal,
                             window, scale, s);
    case 128:
      return (int)launch<128>(q, k, v, o, B, Sq, Tk, H, KH, is_bf16, causal,
                              window, scale, s);
    case 256:
      return (int)launch<256>(q, k, v, o, B, Sq, Tk, H, KH, is_bf16, causal,
                              window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
