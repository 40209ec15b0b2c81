// FlashAttention-2 forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces ray_tpu/ops/attention.py::_flash_fwd_kernel (the Pallas TPU
// kernel called from _flash_fwd_pallas). Same function:
//   O   = softmax(scale * Q K^T + mask) V        (fp32 math, O in input dtype)
//   LSE = m + log(max(l, 1e-30))                  (fp32, one value per q row)
// with the causal mask top-left aligned (key index <= query index, no
// offset even when Sq != Sk), keys >= Sk masked with NEG_INF = -1e30, and
// the same online-softmax recurrence over key tiles.
//
// Layout: q [B, Sq, H, D], k/v [B, Sk, Hkv, D] read through their batch,
// sequence and head strides (the last dim must be contiguous), so neither
// a [B*H, S, D] transpose nor padding copies are made. Query head h reads
// KV head h / (H / Hkv): grouped-query attention without gqa_expand.
// O is written [B, Sq, H, D], LSE [B, H, Sq].
//
// What bounds it on an H100: at the serving prefill shape (S=2048, D=128,
// causal) attention does ~800 operations per byte it must move, so it is
// bound by arithmetic, not by HBM. This first kernel does its arithmetic in
// fp32 on the CUDA cores (67 TFLOP/s), as the Pallas body does, not on the
// tensor cores (989 TFLOP/s bf16), so it stays well above the card's bound.
// What the design does about the arithmetic it has: each CTA stages one
// 64-row Q tile (pre-scaled, fp32) and 32-row K/V tiles in shared memory;
// each of 256 threads keeps a 4x2 register tile of scores and a 4x(D/16)
// register tile of the output, so every shared-memory read feeds several
// FMAs; rows are padded by one float so neither operand read conflicts on
// banks; key tiles wholly above the causal diagonal are skipped, and the
// heaviest (last) query tiles are scheduled first. wgmma/TMA tiles are a
// later step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per CTA
constexpr int BN = 32;        // key rows per tile
constexpr int NT = 256;       // threads per CTA: a 16 x 16 grid (ty, tx)
constexpr float NEG_INF = -1e30f;

struct FlashFwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int sq, sk, h, group;  // group = H / Hkv
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr int smem_floats() {
  return BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FlashFwdArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [BM][D+1], q * scale
  float* ks = qs + BM * (D + 1);    // [BN][D+1]
  float* vs = ks + BN * (D + 1);    // [BN][D]
  float* ps = vs + BN * D;          // [BM][BN+1], probabilities of this tile

  constexpr int DJ = D / 16;        // output columns per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  for (int idx = tid; idx < BM * D; idx += NT) {
    const int r = idx / D, c = idx % D, qi = q0 + r;
    qs[r * (D + 1) + c] = qi < a.sq ? to_f32(qp[qi * a.q_ss + c]) * a.scale : 0.f;
  }

  float acc[4][DJ];
  float m[4], l[4];  // l: this thread's share of the row sum (summed at the end)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = a.causal ? min(q0 + BM, a.sk) : a.sk;
  const int nk = (kv_end + BN - 1) / BN;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BN;
    __syncthreads();  // the previous tile's ks/vs/ps are no longer read
    for (int idx = tid; idx < BN * D; idx += NT) {
      const int r = idx / D, c = idx % D, ki = k0 + r;
      const bool ok = ki < a.sk;  // zero rows past Sk: p is 0 there, v must not be NaN
      ks[r * (D + 1) + c] = ok ? to_f32(kp[ki * a.k_ss + c]) : 0.f;
      vs[r * D + c] = ok ? to_f32(vp[ki * a.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ki = k0 + tx + 16 * j;
        if (ki >= a.sk || (a.causal && qi < ki)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of one row are 16 neighbouring lanes of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * (BN + 1) + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (BN + 1) + n];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[n * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int qi = q0 + ty + 16 * i;
    if (qi < a.sq) {
      const float denom = fmaxf(lt, 1e-30f);
      T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + qi * a.o_ss;
#pragma unroll
      for (int j = 0; j < DJ; ++j) store(op + tx + 16 * j, acc[i][j] / denom);
      if (tx == 0) a.lse[(static_cast<int64_t>(b) * a.h + h) * a.sq + qi] = m[i] + logf(denom);
    }
  }
}

template <typename T, int D>
int launch(const FlashFwdArgs& a, int batch, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + BM - 1) / BM, a.h, batch);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const FlashFwdArgs& a, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(a, batch, stream);
    case 64: return launch<T, 64>(a, batch, stream);
    case 128: return launch<T, 128>(a, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point. dtype: 0 = float32, 1 = bfloat16. Strides are in
// elements. Returns a cudaError_t value: 0 when the launch was accepted.
extern "C" int ray_tpu_torch_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
    int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    float scale, int causal, void* stream) {
  FlashFwdArgs a{q, k, v, o, lse,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                 sq, sk, heads, heads / kv_heads, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(a, batch, head_dim, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, batch, head_dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
