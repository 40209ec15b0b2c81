// FlashAttention-2 backward, dQ pass, on Hopper's tensor cores (sm_90a):
// wgmma, TMA and warp specialisation, hand-written CUDA C++. Takes bf16
// inputs; fp32 inputs keep the CUDA-core dQ kernel of flash_bwd.cu, and
// the dK/dV pass stays there for both types.
//
// Replaces ray_tpu/ops/attention.py::_flash_bwd_dq_kernel (the Pallas TPU
// kernel called from _flash_bwd_pallas). Same function, from the forward's
// saved LSE and the row term Delta = rowsum(dO * O) (both fp32, [B, H, Sq];
// Delta is the torch expression _flash_bwd_delta, as the JAX package
// computes it outside Pallas):
//   P  = exp(q*scale K^T - LSE)       where the mask keeps (q, k), else 0
//   dS = P * (dO V^T - Delta)
//   dQ = scale * dS K                  (dQ in bf16)
// with the causal mask top-left aligned (key index <= query index, also
// when Sq != Sk) and keys >= Sk masked. S, dP and dQ accumulate in fp32.
// Where bf16 rounds: the tensor cores take dS in bf16 for dS·K, so dS is
// rounded to bf16 before that product (the Pallas kernel keeps it in fp32;
// the plain version _flash_bwd_reference rounds it the same way for bf16
// inputs).
//
// Layout: q, dO [B, Sq, H, D] and k, v [B, Sk, Hkv, D] are read by TMA
// through 4-D tensor maps over their strides (no padding, transpose or
// gqa_expand copy; TMA fills rows past Sq and Sk with zeros); query head h
// reads KV head h / (H / Hkv); dQ is written [B, Sq, H, D]. No atomics: dQ
// is a pass of its own, as in the JAX package, so it is the same on every
// run.
//
// What bounds it on an H100: at the training shape (B=8, S=2048, 32 heads,
// D=128, causal) it does 6*D operations per kept (q, k) pair and head,
// ~600 per byte it must move, so the bf16 tensor cores (989 TFLOP/s) bound
// it. The design: one CTA per (128-row query tile, query head, batch), the
// heaviest causal tiles first; a producer warpgroup (setmaxnreg down, one
// thread issuing TMA) loads the Q and dO tiles once and streams 64-row K
// and V tiles up to the diagonal through a ring of two shared-memory
// stages (full barriers for K and for V, one empty barrier per stage). Two
// consumer warpgroups of 64 query rows each keep LSE and Delta of their
// rows in registers and per tile run S = Q·Kᵀ and dP = dO·Vᵀ by wgmma from
// shared memory (dP's product runs while P = exp2(S·scale·log2e −
// LSE·log2e) is computed), form dS = P∘(dP − Δ) in registers, and run
// dQ += dS·K with dS as the register A operand and K read MN-major from
// the same stage. A warpgroup whose rows lie wholly above a key tile only
// releases the stage.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;  // query rows per CTA: two consumer warpgroups of 64
constexpr int BN = 64;   // key rows per stage
constexpr int STAGES = 2;
constexpr int NT = 384;  // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128*40 + 256*232 = 384*168

struct DqArgs {
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* dq;
  int64_t dq_sb, dq_ss, dq_sh;
  int sq, sk, h, group;  // group = H / Hkv
  float scale, scale_log2;
  int causal;
};

template <int D>
struct Smem {
  using QT = Tile<D, BM>;
  using KT = Tile<D, BN>;
  static constexpr int Q = 0;
  static constexpr int DO = QT::BYTES;
  static constexpr int K = DO + QT::BYTES;
  static constexpr int V = K + STAGES * KT::BYTES;
  static constexpr int BAR = V + STAGES * KT::BYTES;
  static constexpr int NBAR = 1 + 3 * STAGES;  // qdo_full, k_full[], v_full[], empty[]
  static constexpr int BYTES = BAR + NBAR * 8 + 1024;  // + slack to align the base to 1024
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do, const DqArgs a) {
  using L = Smem<D>;
  using QT = typename L::QT;
  using KT = typename L::KT;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must start on 1024-byte boundaries
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_q = smem_u32(smem + L::Q);
  const uint32_t s_do = smem_u32(smem + L::DO);
  const uint32_t s_k = smem_u32(smem + L::K);
  const uint32_t s_v = smem_u32(smem + L::V);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* k_full = qdo_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv_end = a.causal ? min(q0 + BM, a.sk) : a.sk;
  const int nk = (kv_end + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread releases the stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      const int hk = h / a.group;
      mbar_expect_tx(qdo_full, 2 * QT::BYTES);
      tma_load_tile<QT>(s_q, &tm_q, qdo_full, h, q0, b);
      tma_load_tile<QT>(s_do, &tm_do, qdo_full, h, q0, b);
      for (int t = 0; t < nk; ++t) {
        const int s = t % STAGES, round = t / STAGES;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        mbar_expect_tx(&k_full[s], KT::BYTES);
        tma_load_tile<KT>(s_k + s * KT::BYTES, &tm_k, &k_full[s], hk, t * BN, b);
        mbar_expect_tx(&v_full[s], KT::BYTES);
        tma_load_tile<KT>(s_v + s * KT::BYTES, &tm_v, &v_full[s], hk, t * BN, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    reg_alloc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int wg_row0 = q0 + 64 * cw;
    const int row_lo = wg_row0 + 16 * warp + lane / 4;  // and row_lo + 8
    const int col_in = 2 * (lane % 4);

    // LSE in log2 units and Delta of this thread's two rows; rows past Sq
    // have zero Q and dO, so 0 keeps their (unstored) dS at 0
    float lse2[2], delta[2];
    const int64_t row0 = (static_cast<int64_t>(b) * a.h + h) * a.sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      lse2[r] = row < a.sq ? a.lse[row0 + row] * LOG2E : 0.f;
      delta[r] = row < a.sq ? a.delta[row0 + row] : 0.f;
    }

    float acc[D / 2];
    float sc[BN / 2], dp[BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;

    mbar_wait(qdo_full, 0);
    for (int t = 0; t < nk; ++t) {
      const int s = t % STAGES;
      const uint32_t parity = (t / STAGES) & 1;
      const int k0 = t * BN;
      if (a.causal && k0 > wg_row0 + 63) {  // every key of the tile is masked for these rows
        mbar_arrive(&empty[s]);
        continue;
      }
      const uint32_t tile_k = s_k + s * KT::BYTES, tile_v = s_v + s * KT::BYTES;

      // S = Q·Kᵀ, then dP = dO·Vᵀ in flight while P is formed (both
      // waits come first: a wait loop between the products would make
      // ptxas serialise them)
      mbar_wait(&k_full[s], parity);
      mbar_wait(&v_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN>(sc, desc_k_major<QT>(s_q, 64 * cw, kk), desc_k_major<KT>(tile_k, 0, kk),
                     kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN>(dp, desc_k_major<QT>(s_do, 64 * cw, kk), desc_k_major<KT>(tile_v, 0, kk),
                     kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P = exp2(S·scale·log2e − LSE·log2e), 0 where masked
      const bool masked = k0 + BN > a.sk || (a.causal && k0 + BN - 1 > wg_row0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        sc[i] = exp2_approx(sc[i] * a.scale_log2 - lse2[(i / 2) % 2]);
        if (masked) {
          const int key = k0 + 8 * (i / 4) + col_in + (i % 2);
          const int row = row_lo + 8 * ((i / 2) % 2);
          if (key >= a.sk || (a.causal && key > row)) sc[i] = 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);

      // dS = P∘(dP − Δ), rounded to bf16 as the register A operand
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] *= dp[i] - delta[(i / 2) % 2];
      uint32_t dsa[BN / 16][4];
      to_a_frags(sc, dsa);

      // dQ += dS·K, K read MN-major from the same stage
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<D>(acc, dsa[kk], desc_mn_major<KT>(tile_k, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(dsa);
      mbar_arrive(&empty[s]);
    }

    // dQ = scale · acc in bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      if (row < a.sq) {
        uint32_t* out = reinterpret_cast<uint32_t*>(  // bf16 pairs
            static_cast<uint16_t*>(a.dq) + b * a.dq_sb + h * a.dq_sh + row * a.dq_ss + col_in);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          out[4 * j] = pack_bf16(acc[4 * j + 2 * r] * a.scale, acc[4 * j + 2 * r + 1] * a.scale);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const DqArgs& a,
           int batch, int kv_heads, const int64_t* st, cudaStream_t stream) {
  using L = Smem<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int rc = encode_bshd<typename L::QT>(&tm_q, q, batch, a.sq, a.h, st, 0);
  if (rc == 0) rc = encode_bshd<typename L::KT>(&tm_k, k, batch, a.sk, kv_heads, st + 3, 1);
  if (rc == 0) rc = encode_bshd<typename L::KT>(&tm_v, v, batch, a.sk, kv_heads, st + 6, 2);
  if (rc == 0) rc = encode_bshd<typename L::QT>(&tm_do, dout, batch, a.sq, a.h, st + 9, 3);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + BM - 1) / BM, a.h, batch);
  flash_bwd_dq_kernel_sm90<D><<<grid, NT, L::BYTES, stream>>>(tm_q, tm_k, tm_v, tm_do, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for bf16 inputs. `strides` holds [batch, sequence,
// head] strides in elements of q, k, v, dout and dq, in that order.
// Returns a cudaError_t value (0 when the launch was accepted) or one of
// sm90's ERR_* codes when a tensor map could not be made.
extern "C" int ray_tpu_torch_flash_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    const int64_t* strides, float scale, int causal, void* stream) {
  const DqArgs a{lse, delta, dq, strides[12], strides[13], strides[14],
                 sq, sk, heads, heads / kv_heads, scale, scale * LOG2E, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch<32>(q, k, v, dout, a, batch, kv_heads, strides, s);
    case 64: return launch<64>(q, k, v, dout, a, batch, kv_heads, strides, s);
    case 128: return launch<128>(q, k, v, dout, a, batch, kv_heads, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the kernel for head_dim (for cudaFuncGetAttributes), or null
extern "C" const void* ray_tpu_torch_flash_bwd_dq_sm90_kernel(int head_dim) {
  switch (head_dim) {
    case 32: return reinterpret_cast<const void*>(flash_bwd_dq_kernel_sm90<32>);
    case 64: return reinterpret_cast<const void*>(flash_bwd_dq_kernel_sm90<64>);
    case 128: return reinterpret_cast<const void*>(flash_bwd_dq_kernel_sm90<128>);
    default: return nullptr;
  }
}
