// Hopper (sm_90a) building blocks in hand-written PTX: mbarriers, TMA tile
// loads, shared-memory swizzles, ldmatrix loads, the
// mma.sync m16n8k16 product and the bf16 hi + lo split of f32 operands,
// wgmma matrix descriptors and the wgmma products that the port's
// tensor-core kernels issue.
//
// Layouts. A tile that TMA writes with a 128-byte (64-byte) swizzle is a run
// of rows of 128 (64) bytes whose 16-byte pieces are permuted: piece p of
// the row that starts at byte offset o lands at piece p ^ ((o >> 7) & 7)
// (p ^ ((o >> 7) & 3)), as CUTLASS's Swizzle<3,4,3> (<2,4,3>) says. The XOR
// reads address bits, so every tile starts at a multiple of 1024 bytes.
// A wgmma descriptor of such a tile names the same swizzle:
//   * K-major (the reduction dimension contiguous, as q rows or k rows):
//     8-row groups `sbo` bytes apart; a k-step of 16 bf16 moves the start
//     by 32 bytes inside the row;
//   * MN-major (the output dimension contiguous, as v rows read as B of
//     P.V): groups of 8 reduction rows `sbo` bytes apart, swizzle atoms
//     along the output dimension `lbo` bytes apart.
#pragma once

#include <cuda.h>  // CUtensorMap: a type only; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset `o` inside a tile of `row_bytes`-byte rows (128 or 64) ->
// where TMA's swizzle of the same width puts it
template <int row_bytes>
__device__ __forceinline__ uint32_t swizzle(uint32_t o) {
  static_assert(row_bytes == 128 || row_bytes == 64, "swizzle width");
  return o ^ (((o >> 7) & (row_bytes == 128 ? 7u : 3u)) << 4);
}

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A wait of 2**34
// clocks (seconds) can only be a fault in the pipeline: it traps, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > (1ll << 34))
      __trap();
  }
}

// --- TMA -----------------------------------------------------------------------

// fetches a tensor map (a __grid_constant__ kernel parameter) into the
// descriptor cache ahead of its first TMA copy
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(
                   map))
               : "memory");
}

// one box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`. Coordinates are innermost first; a box that runs past the
// tensor's edge is filled with zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of a 3-D tensor map into shared memory, as tma_load_4d
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// orders this thread's plain shared-memory stores before later reads by the
// async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// --- distributed shared memory ---------------------------------------------------

// the shared::cluster address of `p` (this block's shared memory) in the
// block of rank `rank` of the cluster
__device__ __forceinline__ uint32_t dsmem_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ float dsmem_ld(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ float4 dsmem_ld4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// --- ldmatrix, mma.sync ---------------------------------------------------------

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Without .trans a lane receives (row lane/4,
// columns 2*(lane%4), +1) of each matrix, with .trans the transpose.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// two matrices: lanes 0-15 give the addresses
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

// d (16 x 8, f32) += A (16 x 16, bf16, row) . B (16 x 8, bf16, col), one
// warp. Fragments (g = lane / 4, t = lane % 4): a = {(g, 2t..2t+1),
// (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}; b = {(k 2t..2t+1, n g),
// (k 2t+8.., n g)}; d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> a bf16 pair (low half = x0) and the pair of what rounding
// left, so that hi + lo carries the f32 values to ~16 bits
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - back.x, x1 - back.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// --- wgmma -----------------------------------------------------------------------

// descriptor of a swizzled bf16 tile at shared address `addr`
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, int row_bytes) {
  const uint64_t mode = row_bytes == 128 ? 1 : 2;  // 128- or 64-byte swizzle
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma operands across
// the wait that completes them (and from reusing an A register early).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOPPER_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d (64 x 64, f32) (+)= A (64 x 16) . B (16 x 64), both bf16 in shared memory,
// both K-major. `accumulate` = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}"
      : HOPPER_F4(0), HOPPER_F4(4), HOPPER_F4(8), HOPPER_F4(12),
        HOPPER_F4(16), HOPPER_F4(20), HOPPER_F4(24), HOPPER_F4(28)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64, bf16 in
// shared memory, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs_mn(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : HOPPER_F4(0), HOPPER_F4(4), HOPPER_F4(8), HOPPER_F4(12),
        HOPPER_F4(16), HOPPER_F4(20), HOPPER_F4(24), HOPPER_F4(28)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// the same with a 32-column B and d
__device__ __forceinline__ void wgmma_m64n32k16_rs_mn(float (&d)[16],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}"
      : HOPPER_F4(0), HOPPER_F4(4), HOPPER_F4(8), HOPPER_F4(12)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef HOPPER_F4

// bf16 A/B . accumulate into an N-column f32 d: N = 64 or 32
template <int N>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  if constexpr (N == 64)
    wgmma_m64n64k16_rs_mn(d, a, desc_b);
  else
    wgmma_m64n32k16_rs_mn(d, a, desc_b);
}

// --- the driver's tensor-map encoder, found at run time ----------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda; null where the driver lacks it
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A contiguous bf16 tensor of 4 dimensions (dims[0] innermost) read in boxes
// of box[0..3] elements, with the swizzle of `row_bytes` (= box[0] * 2, 128
// or 64). Returns cudaErrorNotSupported where the driver has no encoder and
// cudaErrorInvalidValue where it refuses the tensor.
inline cudaError_t make_map_4d(CUtensorMap* map, const void* base,
                               const uint64_t (&dims)[4],
                               const uint32_t (&box)[4], int row_bytes) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t gbox[4], estride[4] = {1, 1, 1, 1};
  uint64_t stride = 2;  // bytes of one bf16
  for (int i = 0; i < 4; ++i) {
    gdim[i] = dims[i];
    gbox[i] = box[i];
    if (i > 0) gstride[i - 1] = stride;
    stride *= dims[i];
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), gdim, gstride, gbox, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// A contiguous f32 tensor of 3 dimensions (dims[0] innermost, a multiple of
// 4 elements, so that every row starts on 16 bytes) read in boxes of
// box[0..2] elements (box[0] * 4 a multiple of 16 bytes), unswizzled: a box
// lands in shared memory as box[1] x box[2] rows of box[0] floats. Elements
// past the tensor's edges are filled with zeros. Errors as make_map_4d.
inline cudaError_t make_map_f32_3d(CUtensorMap* map, const void* base,
                                   const uint64_t (&dims)[3],
                                   const uint32_t (&box)[3]) {
  const EncodeTiledFn encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t gdim[3] = {dims[0], dims[1], dims[2]};
  const cuuint64_t gstride[2] = {dims[0] * 4, dims[0] * dims[1] * 4};
  const cuuint32_t gbox[3] = {box[0], box[1], box[2]};
  const cuuint32_t estride[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(base), gdim, gstride, gbox, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// Sets a kernel's dynamic shared memory limit once per device (the
// attribute holds until the process ends), not on every launch. `done` is
// the kernel's own flag word: one bit per device ordinal below 32.
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (__atomic_load_n(&done, __ATOMIC_ACQUIRE) & bit))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && bit)
    __atomic_fetch_or(&done, bit, __ATOMIC_RELEASE);
  return err;
}

}  // namespace hopper
