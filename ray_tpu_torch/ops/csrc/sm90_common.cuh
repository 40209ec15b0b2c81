// Hopper (sm_90a) building blocks shared by the tensor-core flash kernels
// (flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu, flash_bwd_dkv_sm90.cu):
// mbarriers, TMA loads of a
// [B, S, H, D] bf16 tensor, wgmma shared-memory descriptors and the wgmma
// instructions themselves, written as inline PTX. No PyTorch header is
// included, so nvcc compiles each kernel file on its own.
//
// Shared-memory tiles. A tile holds ROWS rows of D bf16 values as TMA
// writes them with a swizzle: one box per SWB columns (SWB = 64 columns =
// 128 bytes, swizzled 128B, for D = 64 and 128; SWB = 32 columns = 64
// bytes, swizzled 64B, for D = 32), the boxes one after the other. Each
// box is ROWS rows of SWB*2 bytes, and every 8 rows form one swizzle atom
// (1024 or 512 bytes), which wgmma reads with the matching layout type.
//
// - K-major operand (Q, dO as A and K, V as B of Q·Kᵀ and dO·Vᵀ; K, V as
//   A and Q, dO as B of K·Qᵀ and V·dOᵀ): 8-row groups are SBO =
//   8*ROW_BYTES apart; a 16-column k slice starts 32 bytes further along
//   the row, or in the next box.
// - MN-major operand (V of P·V, K of dS·K, dO of Pᵀ·dO and Q of dSᵀ·Q,
//   read with the transpose bit): a 16-row k slice starts 16*ROW_BYTES
//   further down; 8-row groups
//   are SBO apart and the next SWB columns (the next box) LBO = one box
//   apart.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr float NEG_INF = -1e30f;  // the masked logit, as in the JAX kernels
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D, int ROWS>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head_dim 32, 64 or 128");
  static constexpr int SWB = D >= 64 ? 64 : 32;  // columns per TMA box
  static constexpr int ROW_BYTES = SWB * 2;
  static constexpr int NBOX = D / SWB;
  static constexpr int BOX_BYTES = ROWS * ROW_BYTES;
  static constexpr int BYTES = NBOX * BOX_BYTES;
  static constexpr int SBO = 8 * ROW_BYTES;
  static constexpr uint32_t LAYOUT = ROW_BYTES == 128 ? 1 : 2;  // wgmma: 128B / 64B swizzle
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- wgmma shared-memory matrix descriptors --------------------------------

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// rows [row0, row0 + 64 or N) of a tile, 16-column k slice kk, K-major
template <class T>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int row0, int kk) {
  const int col = kk * 16;
  const uint32_t addr = tile + (col / T::SWB) * T::BOX_BYTES + row0 * T::ROW_BYTES +
                        (col % T::SWB) * 2;
  return make_desc(addr, 16, T::SBO, T::LAYOUT);
}

// all D columns of a tile as the N side, 16-row k slice kk, MN-major
template <class T>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * T::ROW_BYTES, T::BOX_BYTES, T::SBO, T::LAYOUT);
}

// ---- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the producer's arrival, announcing `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that
// outlasts MBAR_TIMEOUT_CYCLES (~10 s) traps, so a fault in the pipeline
// ends the launch with an error instead of hanging the card
constexpr long long MBAR_TIMEOUT_CYCLES = 20000000000LL;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > MBAR_TIMEOUT_CYCLES) __trap();
  }
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory; the bytes complete on `bar`. Rows past the tensor's end are zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// 4 bytes from global to shared memory, asynchronously; bytes past
// src_bytes (0 or 4) are zeros
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies have
// landed (counted in the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// all NBOX boxes of rows [row, row + ROWS) of one head of a [B, S, H, D] map
template <class T>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map,
                                              uint64_t* bar, int head, int row, int batch) {
#pragma unroll
  for (int j = 0; j < T::NBOX; ++j)
    tma_load_4d(dst + j * T::BOX_BYTES, map, bar, j * T::SWB, head, row, batch);
}

// ---- warp specialisation ----------------------------------------------------

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// ---- wgmma ------------------------------------------------------------------

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

// keep the compiler from touching registers an in-flight wgmma owns
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats to packed bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The m64nNk16 accumulator of a warpgroup: thread t (warp w = t/32, lane l)
// holds N/2 floats; element i is row 16w + l/4 + 8*((i/2)%2), column
// 8*(i/4) + 2*(l%4) + i%2. Columns 16kk..16kk+15 of it, packed to bf16 as
// {i = 8kk+0,1 | 8kk+2,3 | 8kk+4,5 | 8kk+6,7}, are exactly the register A
// fragment of a k16 slice: a product's output feeds the next product.
template <int R, int K>
__device__ __forceinline__ void to_a_frags(const float (&d)[R], uint32_t (&a)[K][4]) {
  static_assert(R == 8 * K, "one k16 slice per 8 accumulator floats");
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[k][i] = pack_bf16(d[8 * k + 2 * i], d[8 * k + 2 * i + 1]);
}

// D(64xN, fp32) (+)= A(64x16, smem, K-major) * B(16xN, smem, K-major);
// scale_d = 0 overwrites D
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d);

// D(64xN, fp32) += A(64x16, registers) * B(16xN, smem, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---- host: tensor maps --------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not the runtime: taken through
// the runtime's entry-point query, so the extension needs no -lcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Error codes of the launchers beyond cudaError_t: the binding names them.
constexpr int ERR_NO_ENCODE = 100000;          // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 200000;             // + 1000 * operand index + CUresult

// A 4-D map over one bf16 [B, S, H, D] tensor (strides in elements, last
// dim contiguous): dims (D, H, S, B), box (SWB, 1, rows, 1). A dimension of
// extent 1 is never stepped over, so it gets the packed stride.
template <class T>
int encode_bshd(CUtensorMap* map, const void* ptr, int b, int s, int h, const int64_t* st,
                int operand) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  constexpr int D = T::NBOX * T::SWB;
  const int64_t sh = h == 1 ? D : st[2];
  const int64_t ss = s == 1 ? h * sh : st[1];
  const int64_t sb = b == 1 ? s * ss : st[0];
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::SWB), 1,
                             static_cast<cuuint32_t>(T::BOX_BYTES / T::ROW_BYTES), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        T::ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                            : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + 1000 * operand + static_cast<int>(r);
}

}  // namespace sm90
