// FlashAttention-2 forward on Hopper's tensor cores (sm_90a): wgmma, TMA
// and warp specialisation, hand-written CUDA C++. Takes bf16 inputs; fp32
// inputs keep the CUDA-core kernel of flash_fwd.cu.
//
// Replaces ray_tpu/ops/attention.py::_flash_fwd_kernel (the Pallas TPU
// kernel called from _flash_fwd_pallas). Same function:
//   O   = softmax(scale * Q K^T + mask) V        (O in bf16)
//   LSE = m + log(max(l, 1e-30))                  (fp32, one value per q row)
// with the causal mask top-left aligned (key index <= query index, no
// offset even when Sq != Sk) and keys >= Sk masked with NEG_INF = -1e30.
// Scores, the softmax and the output accumulate in fp32. Where bf16 rounds:
// the tensor cores take P in bf16 for P·V, so P = exp(s - m) is rounded to
// bf16 before that product (the Pallas kernel keeps it in fp32; the JAX
// package's mha_reference and _block_step round it the same way, and so
// does the plain version _flash_fwd_reference for bf16 inputs). The row
// sum l is taken over the fp32 P.
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, Hkv, D] are read by TMA through 4-D
// tensor maps over their strides, so no transpose, padding or gqa_expand
// copy is made; TMA fills rows past Sq and Sk with zeros. Query head h
// reads KV head h / (H / Hkv). O is written [B, Sq, H, D], LSE [B, H, Sq].
//
// What bounds it on an H100: at the serving prefill and training shapes
// (S=2048, D=128, causal) attention does ~800 operations per byte it must
// move, so it is bound by the bf16 tensor cores (989 TFLOP/s), not HBM.
// The design: one CTA per (128-row query tile, query head, batch), the
// heaviest causal tiles first; three warpgroups. The producer warpgroup
// gives up registers (setmaxnreg) and one thread of it issues TMA: the Q
// tile once, then K and V tiles of 128 rows through a ring of two
// shared-memory stages, each with full barriers (one for K, one for V)
// and an empty barrier. Two consumer warpgroups take the registers and 64
// query rows each: S = Q·Kᵀ by wgmma from shared memory, the online
// softmax in registers (scale folded into exp2, the row max and sum
// reduced over the four threads that share a row, the mask applied only
// on diagonal and ragged tiles), then O += P·V by wgmma with P as the
// register A operand and V read MN-major. Overlapping one warpgroup's
// softmax with the other's products (FA3's ping-pong) and persistent CTAs
// are later work.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;      // query rows per CTA: two consumer warpgroups of 64
constexpr int BN = 128;      // key rows per stage
constexpr int STAGES = 2;
constexpr int NT = 384;      // producer warpgroup + two consumer warpgroups
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128*40 + 256*232 = 384*168

struct FwdArgs {
  void* o;
  float* lse;
  int64_t o_sb, o_ss, o_sh;
  int sq, sk, h, group;  // group = H / Hkv
  float scale_log2;      // scale * log2(e)
  int causal;
};

template <int D>
struct Smem {
  using QT = Tile<D, BM>;
  using KT = Tile<D, BN>;
  static constexpr int Q = 0;
  static constexpr int K = QT::BYTES;
  static constexpr int V = K + STAGES * KT::BYTES;
  static constexpr int BAR = V + STAGES * KT::BYTES;
  static constexpr int NBAR = 1 + 3 * STAGES;  // q_full, k_full[], v_full[], empty[]
  static constexpr int BYTES = BAR + NBAR * 8 + 1024;  // + slack to align the base to 1024
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const FwdArgs a) {
  using L = Smem<D>;
  using QT = typename L::QT;
  using KT = typename L::KT;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must start on 1024-byte boundaries
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_q = smem_u32(smem + L::Q);
  const uint32_t s_k = smem_u32(smem + L::K);
  const uint32_t s_v = smem_u32(smem + L::V);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv_end = a.causal ? min(q0 + BM, a.sk) : a.sk;
  const int nk = (kv_end + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
      mbar_expect_tx(q_full, QT::BYTES);
      tma_load_tile<QT>(s_q, &tm_q, q_full, h, q0, b);
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
    const int row_lo = q0 + 64 * cw + 16 * warp + lane / 4;  // and row_lo + 8
    const int col_in = 2 * (lane % 4);

    float acc[D / 2];
    float sc[BN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};  // running max, log2 units
    float l[2] = {0.f, 0.f};          // this thread's share of the row sum

    mbar_wait(q_full, 0);
    for (int t = 0; t < nk; ++t) {
      const int s = t % STAGES;
      const uint32_t parity = (t / STAGES) & 1;
      const int k0 = t * BN;

      // S = Q·Kᵀ
      mbar_wait(&k_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BN>(sc, desc_k_major<QT>(s_q, 64 * cw, kk),
                     desc_k_major<KT>(s_k + s * KT::BYTES, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax in log2 units
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] *= a.scale_log2;
      const bool ragged = k0 + BN > a.sk;
      const bool diagonal = a.causal && k0 + BN - 1 > q0 + 64 * cw;
      if (ragged || diagonal) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + col_in + (i % 2);
          const int row = row_lo + 8 * ((i / 2) % 2);
          if (key >= a.sk || (a.causal && key > row)) sc[i] = NEG_INF;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2_approx(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        sc[i] = exp2_approx(sc[i] - mx[(i / 2) % 2]);
        rs[(i / 2) % 2] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

      // O += P·V, P rounded to bf16 as the register A operand
      uint32_t pa[BN / 16][4];
      to_a_frags(sc, pa);
      mbar_wait(&v_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<D>(acc, pa[kk], desc_mn_major<KT>(s_v + s * KT::BYTES, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(&empty[s]);
    }

    // epilogue: O = acc / max(l, 1e-30) in bf16, LSE in natural-log units
    float inv[2], lse[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float denom = fmaxf(l[r], 1e-30f);
      inv[r] = 1.f / denom;
      lse[r] = (m[r] + log2f(denom)) * LN2;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      if (row < a.sq) {
        uint32_t* op = reinterpret_cast<uint32_t*>(  // bf16 pairs
            static_cast<uint16_t*>(a.o) + b * a.o_sb + h * a.o_sh + row * a.o_ss + col_in);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          op[4 * j] = pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
        if (lane % 4 == 0) a.lse[(static_cast<int64_t>(b) * a.h + h) * a.sq + row] = lse[r];
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const FwdArgs& a, int batch,
           int kv_heads, const int64_t* st, cudaStream_t stream) {
  using L = Smem<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  // A runtime call first: it makes the device's context current on this
  // thread, so the libcuda calls that encode the tensor maps run inside it.
  // A thread that has made no runtime call has no current context, and
  // cuTensorMapEncodeTiled there crashed under CUPTI tracing (torch.profiler
  // with CUDA activity) when the launch came from a thread other than the
  // profiler's.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = encode_bshd<typename L::QT>(&tm_q, q, batch, a.sq, a.h, st, 0);
  if (rc == 0) rc = encode_bshd<typename L::KT>(&tm_k, k, batch, a.sk, kv_heads, st + 3, 1);
  if (rc == 0) rc = encode_bshd<typename L::KT>(&tm_v, v, batch, a.sk, kv_heads, st + 6, 2);
  if (rc != 0) return rc;
  const dim3 grid((a.sq + BM - 1) / BM, a.h, batch);
  flash_fwd_kernel_sm90<D><<<grid, NT, L::BYTES, stream>>>(tm_q, tm_k, tm_v, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for bf16 inputs. `strides` holds [batch, sequence,
// head] strides in elements of q, k, v and o, in that order. Returns a
// cudaError_t value (0 when the launch was accepted) or one of sm90's
// ERR_* codes when a tensor map could not be made.
extern "C" int ray_tpu_torch_flash_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    const int64_t* strides, float scale, int causal, void* stream) {
  const FwdArgs a{o, lse, strides[9], strides[10], strides[11],
                  sq, sk, heads, heads / kv_heads, scale * LOG2E, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch<32>(q, k, v, a, batch, kv_heads, strides, s);
    case 64: return launch<64>(q, k, v, a, batch, kv_heads, strides, s);
    case 128: return launch<128>(q, k, v, a, batch, kv_heads, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the kernel for head_dim (for cudaFuncGetAttributes), or null
extern "C" const void* ray_tpu_torch_flash_fwd_sm90_kernel(int head_dim) {
  switch (head_dim) {
    case 32: return reinterpret_cast<const void*>(flash_fwd_kernel_sm90<32>);
    case 64: return reinterpret_cast<const void*>(flash_fwd_kernel_sm90<64>);
    case 128: return reinterpret_cast<const void*>(flash_fwd_kernel_sm90<128>);
    default: return nullptr;
  }
}
