// FlashAttention-2 backward, dK/dV pass, on Hopper's tensor cores (sm_90a):
// wgmma, TMA and mbarrier pipelines, hand-written CUDA C++. Takes bf16
// inputs; fp32 inputs keep the CUDA-core dK/dV kernel of flash_bwd.cu
// (tensor cores have no fp32 mode, and TF32 keeps ~3 digits).
//
// Replaces ray_tpu/ops/attention.py::_flash_bwd_dkv_kernel (the Pallas TPU
// kernel called from _flash_bwd_pallas). Same function, from the forward's
// saved LSE and the row term Delta = rowsum(dO * O) (both fp32, [B, H, Sq]):
//   P  = exp(q*scale K^T - LSE)       where the mask keeps (q, k), else 0
//   dS = P * (dO V^T - Delta)
//   dV = P^T dO,  dK = scale * dS^T q  (dK, dV in bf16)
// with the causal mask top-left aligned (key index <= query index, also
// when Sq != Sk) and queries >= Sq masked. Each KV head's dK/dV is summed
// over its group of query heads. S, dP, dK and dV accumulate in fp32.
// Where bf16 rounds: the tensor cores take P and dS in bf16 for P^T·dO and
// dS^T·q, so both are rounded to bf16 before those products, as the plain
// version _flash_bwd_reference rounds them for bf16 inputs (the Pallas
// kernel keeps them in fp32).
//
// Layout: q, dO [B, Sq, H, D] and k, v [B, Sk, Hkv, D] are read by TMA
// through 4-D tensor maps over their strides (no padding, transpose or
// gqa_expand copy; TMA fills rows past Sq and Sk with zeros); dK, dV are
// written [B, Sk, Hkv, D]. The JAX package expands K/V before its kernel
// and autodiff sums dK/dV over the repeats; here the CTA of one KV head
// loops over the head's whole group of query heads h = hk * group + g
// itself, so the sum needs no atomics and is the same on every run.
//
// What bounds it on an H100: at the training shape (B=8, S=2048, 32 heads,
// D=128, causal) it does 8*D operations per kept (q, k) pair and head (S,
// dP, dV, dK), ~600+ per byte it must move, so the bf16 tensor cores (989
// TFLOP/s) bound it. The design: one CTA per (128-row key tile, KV head,
// batch), key tile 0 (the heaviest under causal) first. The K and V tiles
// are loaded once (TMA); 64-row Q and dO tiles, from the first query that
// sees the key tile on, stream through a ring of four shared-memory stages
// (TMA, with each tile's LSE and Delta copied beside them by cp.async, so
// the per-query terms of the transposed layout come from shared memory).
// Two warpgroups of 64 keys each keep dK and dV in registers and per tile
// run S^T = K·q^T and dP^T = V·dO^T by wgmma from shared memory (dP's
// product runs while P^T is formed), form
// dS^T = P^T∘(dP^T − Δ) in registers, and issue dV += P^T·dO and dK +=
// dS^T·q together, with P^T and dS^T as register A operands and dO and q
// read MN-major from the stage. A warpgroup whose keys all lie after
// every query of a tile only releases the stage; the mask is applied only
// on diagonal and ragged tiles. A key tile that no query sees (causal,
// first key >= Sq) loads nothing and writes zeros.

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int BK = 128;  // key rows per CTA: two warpgroups of 64
constexpr int BQ = 64;   // query rows per stage
constexpr int STAGES = 4;  // the most that fits in shared memory at D=128 (~195 KB)
// Two warpgroups, both computing; warp 0 also issues the loads. No
// producer warpgroup and no setmaxnreg: dK and dV (128 fp32 registers a
// thread) beside S, dP and the bf16 operands need ~248 registers, which
// 256 threads may hold. With a producer warpgroup (384 threads; 288 are
// allocated as 384) ptxas allocated the compute warpgroups' setmaxnreg
// region close to the kernel-wide 168 registers: it spilled part of dK
// every tile and serialised the wgmmas (C7512).
constexpr int NT = 256;

struct DkvArgs {
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* dk;
  void* dv;
  int64_t dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int sq, sk, h, group;  // group = H / Hkv
  float scale, scale_log2;
  int causal;
};

template <int D>
struct Smem {
  using KT = Tile<D, BK>;
  using QT = Tile<D, BQ>;
  static constexpr int K = 0;
  static constexpr int V = KT::BYTES;
  static constexpr int Q = 2 * KT::BYTES;
  static constexpr int DO = Q + STAGES * QT::BYTES;
  static constexpr int LSE = DO + STAGES * QT::BYTES;  // [STAGES][BQ] fp32
  static constexpr int DELTA = LSE + STAGES * BQ * 4;  // [STAGES][BQ] fp32
  static constexpr int BAR = DELTA + STAGES * BQ * 4;
  static constexpr int NBAR = 1 + 2 * STAGES;  // kv_full, full[], empty[]
  static constexpr int BYTES = BAR + NBAR * 8 + 1024;  // + slack to align the base to 1024
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do, const DkvArgs a) {
  using L = Smem<D>;
  using KT = typename L::KT;
  using QT = typename L::QT;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must start on 1024-byte boundaries
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_k = smem_u32(smem + L::K);
  const uint32_t s_v = smem_u32(smem + L::V);
  const uint32_t s_q = smem_u32(smem + L::Q);
  const uint32_t s_do = smem_u32(smem + L::DO);
  const float* s_lse = reinterpret_cast<const float*>(smem + L::LSE);
  const float* s_delta = reinterpret_cast<const float*>(smem + L::DELTA);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * BK;  // causal: the first key tiles see the most queries
  const int hk = blockIdx.y, b = blockIdx.z;
  // Under the causal mask no query before k0 sees this tile (k0 is a
  // multiple of BQ); with Sk > Sq a tile may see no query at all.
  const int q_start = a.causal ? k0 : 0;
  const int nq = q_start < a.sq ? (a.sq - q_start + BQ - 1) / BQ : 0;  // per query head
  const int ntiles = a.group * nq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // lane 0's TMA bytes + warp 0's LSE/Delta copies
      mbar_init(&empty[s], NT);  // every thread releases the stage
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Warp 0 loads query tile t into stage t % STAGES: lane 0 Q and dO by
  // TMA, every lane LSE and Delta by cp.async (zeros for queries >= Sq).
  // LSE and Delta are indexed by query, the column of S^T: every thread
  // needs 16 of each per tile, so they are staged once beside Q and dO
  // rather than read from L2 by each thread. All of it completes on full[s].
  const int lane = threadIdx.x % 32;
  auto load_tile = [&](int t) {
    const int s = t % STAGES;
    const int h = hk * a.group + t / nq, q0 = q_start + (t % nq) * BQ;
    if (lane == 0) {
      mbar_expect_tx(&full[s], 2 * QT::BYTES);
      tma_load_tile<QT>(s_q + s * QT::BYTES, &tm_q, &full[s], h, q0, b);
      tma_load_tile<QT>(s_do + s * QT::BYTES, &tm_do, &full[s], h, q0, b);
    }
    const int64_t row0 = (static_cast<int64_t>(b) * a.h + h) * a.sq;
#pragma unroll
    for (int j = lane; j < BQ; j += 32) {
      const int q = min(q0 + j, a.sq - 1);
      const uint32_t n = q0 + j < a.sq ? 4 : 0;
      cp_async_4(smem_u32(s_lse + s * BQ + j), a.lse + row0 + q, n);
      cp_async_4(smem_u32(s_delta + s * BQ + j), a.delta + row0 + q, n);
    }
    cp_async_mbar_arrive(&full[s]);
    __syncwarp();
  };
  const bool loader = threadIdx.x < 32;
  if (loader && ntiles > 0) {
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * KT::BYTES);
      tma_load_tile<KT>(s_k, &tm_k, kv_full, hk, k0, b);
      tma_load_tile<KT>(s_v, &tm_v, kv_full, hk, k0, b);
    }
    for (int t = 0; t < min(STAGES, ntiles); ++t) load_tile(t);
  }

  // ---- both warpgroups: 64 keys each ----
  const int cw = threadIdx.x / 128;
  const int warp = threadIdx.x % 128 / 32;
  const int key_lo = k0 + 64 * cw;                    // this warpgroup's first key
  const int key_row = key_lo + 16 * warp + lane / 4;  // and key_row + 8
  const int col_in = 2 * (lane % 4);

  float dk[D / 2], dv[D / 2];
  float sc[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) sc[i] = dp[i] = 0.f;

  if (ntiles > 0) mbar_wait(kv_full, 0);
  for (int t = 0; t < ntiles; ++t) {
    // tile t + STAGES - 1 goes into the stage tile t - 1 held, once both
    // warpgroups have released it: warp 0 runs at most a tile ahead of
    // the other warpgroup
    if (loader && t > 0 && t + STAGES - 1 < ntiles) {
      mbar_wait(&empty[(t - 1) % STAGES], ((t - 1) / STAGES) & 1);
      load_tile(t + STAGES - 1);
    }
    const int s = t % STAGES;
    const int q0 = q_start + (t % nq) * BQ;
    // Wait for the stage even when it is skipped: each warpgroup then
    // releases stage s once per round, in order, so one warpgroup's
    // releases never complete a round the other is still reading.
    mbar_wait(&full[s], (t / STAGES) & 1);
    if (a.causal && key_lo > q0 + BQ - 1) {  // every key of this warpgroup is masked
      mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t tile_q = s_q + s * QT::BYTES, tile_do = s_do + s * QT::BYTES;
    const float* lse = s_lse + s * BQ;
    const float* delta = s_delta + s * BQ;

    // S^T = K·q^T, then dP^T = V·dO^T in flight while P^T is formed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ>(sc, desc_k_major<KT>(s_k, 64 * cw, kk), desc_k_major<QT>(tile_q, 0, kk),
                   kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ>(dp, desc_k_major<KT>(s_v, 64 * cw, kk), desc_k_major<QT>(tile_do, 0, kk),
                   kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P^T = exp2(S^T·scale·log2e − LSE·log2e), 0 where masked; element i
    // is key key_row + 8*((i/2)%2) and query q0 + 8*(i/4) + col_in + i%2
    const bool masked = q0 + BQ > a.sq || key_lo + 64 > a.sk || (a.causal && key_lo + 63 > q0);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int col = 8 * (i / 4) + col_in + (i % 2);
      sc[i] = exp2_approx(sc[i] * a.scale_log2 - lse[col] * LOG2E);
      if (masked) {
        const int q = q0 + col, key = key_row + 8 * ((i / 2) % 2);
        if (q >= a.sq || key >= a.sk || (a.causal && key > q)) sc[i] = 0.f;
      }
    }

    wgmma_wait<0>();
    fence_regs(dp);

    // dS^T = P^T∘(dP^T − Δ) in place of dP^T; P^T and dS^T rounded to
    // bf16 as register A operands
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i)
      dp[i] = sc[i] * (dp[i] - delta[8 * (i / 4) + col_in + (i % 2)]);
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    to_a_frags(sc, pa);
    to_a_frags(dp, dsa);

    // dV += P^T·dO and dK += dS^T·q, dO and q read MN-major from the stage
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<D>(dv, pa[kk], desc_mn_major<QT>(tile_do, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<D>(dk, dsa[kk], desc_mn_major<QT>(tile_q, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(dsa);
    mbar_arrive(&empty[s]);
  }

  // dK = scale · acc and dV in bf16; keys >= Sk are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_row + 8 * r;
    if (key < a.sk) {
      uint32_t* out_k = reinterpret_cast<uint32_t*>(  // bf16 pairs
          static_cast<uint16_t*>(a.dk) + b * a.dk_sb + hk * a.dk_sh + key * a.dk_ss + col_in);
      uint32_t* out_v = reinterpret_cast<uint32_t*>(
          static_cast<uint16_t*>(a.dv) + b * a.dv_sb + hk * a.dv_sh + key * a.dv_ss + col_in);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        out_k[4 * j] = pack_bf16(dk[4 * j + 2 * r] * a.scale, dk[4 * j + 2 * r + 1] * a.scale);
        out_v[4 * j] = pack_bf16(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const DkvArgs& a,
           int batch, int kv_heads, const int64_t* st, cudaStream_t stream) {
  using L = Smem<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  // A runtime call first: it makes the device's context current on this
  // thread, so the libcuda calls that encode the tensor maps run inside it.
  // A thread that has made no runtime call has no current context, and
  // cuTensorMapEncodeTiled there crashed under CUPTI tracing (torch.profiler
  // with CUDA activity) when the launch came from a thread other than the
  // profiler's.
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = encode_bshd<typename L::QT>(&tm_q, q, batch, a.sq, a.h, st, 0);
  if (rc == 0) rc = encode_bshd<typename L::KT>(&tm_k, k, batch, a.sk, kv_heads, st + 3, 1);
  if (rc == 0) rc = encode_bshd<typename L::KT>(&tm_v, v, batch, a.sk, kv_heads, st + 6, 2);
  if (rc == 0) rc = encode_bshd<typename L::QT>(&tm_do, dout, batch, a.sq, a.h, st + 9, 3);
  if (rc != 0) return rc;
  const dim3 grid((a.sk + BK - 1) / BK, kv_heads, batch);
  flash_bwd_dkv_kernel_sm90<D><<<grid, NT, L::BYTES, stream>>>(tm_q, tm_k, tm_v, tm_do, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for bf16 inputs. `strides` holds [batch, sequence,
// head] strides in elements of q, k, v, dout, dk and dv, in that order.
// Returns a cudaError_t value (0 when the launch was accepted) or one of
// sm90's ERR_* codes when a tensor map could not be made.
extern "C" int ray_tpu_torch_flash_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    const int64_t* strides, float scale, int causal, void* stream) {
  const DkvArgs a{lse, delta, dk, dv,
                  strides[12], strides[13], strides[14], strides[15], strides[16], strides[17],
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
extern "C" const void* ray_tpu_torch_flash_bwd_dkv_sm90_kernel(int head_dim) {
  switch (head_dim) {
    case 32: return reinterpret_cast<const void*>(flash_bwd_dkv_kernel_sm90<32>);
    case 64: return reinterpret_cast<const void*>(flash_bwd_dkv_kernel_sm90<64>);
    case 128: return reinterpret_cast<const void*>(flash_bwd_dkv_kernel_sm90<128>);
    default: return nullptr;
  }
}
