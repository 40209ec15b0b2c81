// FlashAttention-2 backward for Hopper (sm_90a), hand-written CUDA C++ on
// the CUDA cores, for fp32 inputs: two kernels, a dQ pass and a dK/dV
// pass. bf16 inputs go to the tensor-core kernels of flash_bwd_dq_sm90.cu
// and flash_bwd_dkv_sm90.cu (tensor cores have no fp32 mode, and TF32
// keeps ~3 digits, short of the fp32 checks).
//
// Replaces ray_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (the Pallas TPU kernels called from
// _flash_bwd_pallas). Same function, from the forward's saved LSE and the
// row term Delta = rowsum(dO * O) (both fp32, [B, H, Sq]):
//   P  = exp(q*scale K^T - LSE)       where the mask keeps (q, k), else 0
//   dS = P * (dO V^T - Delta)
//   dQ = scale * dS K                  (dQ pass)
//   dV = P^T dO,  dK = dS^T (q*scale)  (dK/dV pass)
// with the causal mask top-left aligned (key index <= query index, also
// when Sq != Sk), keys >= Sk and queries >= Sq masked inside the kernel.
//
// Layout: q, dO [B, Sq, H, D] and k, v [B, Sk, Hkv, D] are read through
// their batch, sequence and head strides (the last dim contiguous), and
// dQ/dK/dV written the same way, so no padding, transpose or gqa_expand
// copy is made. Query head h reads KV head h / (H / Hkv). The JAX package
// expands K/V before its kernel and autodiff sums dK/dV over the repeats;
// here the dK/dV CTA of one KV head loops over its whole group of query
// heads itself, so the sum needs no atomics and comes out the same on
// every run.
//
// What bounds it on an H100: at the training shape (B=8, S=2048, 32 heads,
// D=128, causal) the dQ pass does 6*D and the dK/dV pass 8*D operations per
// (q, k) pair the mask keeps: 600-700 operations per byte they must move,
// above the card's ~295, so both are bound by arithmetic, here the fp32
// CUDA cores' 67 TFLOP/s. What the design does about the
// arithmetic it has: each CTA keeps its own tile (q and dO rows for dQ; K
// and V rows for dK/dV) in shared memory for its whole loop and
// streams the other side through in 32-row tiles; each of 256 threads holds
// a 4x2 register tile of the scores and of dO V^T, and a 4x(D/16) register
// tile of each output, so every shared-memory read feeds several FMAs; rows
// are padded by one float so no operand read conflicts on banks; tiles
// wholly above the causal diagonal are skipped, and the heaviest CTAs are
// scheduled first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per CTA: a 16 x 16 grid (ty, tx)
constexpr int DQ_BM = 64;   // dQ pass: query rows per CTA
constexpr int DQ_BN = 32;   // dQ pass: key rows per streamed tile
constexpr int DKV_BK = 64;  // dK/dV pass: key rows per CTA
constexpr int DKV_BQ = 32;  // dK/dV pass: query rows per streamed tile

// Strides in elements, [batch, sequence, head] per tensor.
struct Strides {
  int64_t b, s, h;
};

struct FlashBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  void* dq;
  void* dk;
  void* dv;
  Strides q_st, k_st, v_st, do_st, dq_st, dk_st, dv_st;
  int sq, sk, h, group;  // group = H / Hkv
  float scale;
  int causal;
};

__device__ __forceinline__ bool kept(int qi, int ki, int sq, int sk, int causal) {
  return qi < sq && ki < sk && (!causal || qi >= ki);
}

// rows [r0, r0 + R) of one head of x into smem rows of pitch D + 1, times
// mul; rows at or past n are zero
template <int D, int R>
__device__ __forceinline__ void load_rows(float* dst, const float* x, int64_t row_stride,
                                          int r0, int n, float mul) {
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int r = idx / D, c = idx % D, ri = r0 + r;
    dst[r * (D + 1) + c] = ri < n ? x[ri * row_stride + c] * mul : 0.f;
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 2 * DQ_BM * (D + 1) + 2 * DQ_BN * (D + 1) + DQ_BM * (DQ_BN + 1);
}

// dQ pass: one CTA per (64-row query tile, query head, batch); loops
// over the key tiles up to the diagonal.
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(FlashBwdArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [BM][D+1], q * scale
  float* dos = qs + DQ_BM * (D + 1);    // [BM][D+1], dO
  float* ks = dos + DQ_BM * (D + 1);    // [BN][D+1]
  float* vs = ks + DQ_BN * (D + 1);     // [BN][D+1]
  float* dss = vs + DQ_BN * (D + 1);    // [BM][BN+1], dS of this tile

  constexpr int DJ = D / 16;  // output columns per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_BM;  // heavy causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;

  const float* qp = static_cast<const float*>(a.q) + b * a.q_st.b + h * a.q_st.h;
  const float* dop = static_cast<const float*>(a.dout) + b * a.do_st.b + h * a.do_st.h;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_st.b + hk * a.k_st.h;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_st.b + hk * a.v_st.h;
  const int64_t row0 = (static_cast<int64_t>(b) * a.h + h) * a.sq;

  load_rows<D, DQ_BM>(qs, qp, a.q_st.s, q0, a.sq, a.scale);
  load_rows<D, DQ_BM>(dos, dop, a.do_st.s, q0, a.sq, 1.f);

  float lse[4], delta[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    lse[i] = qi < a.sq ? a.lse[row0 + qi] : 0.f;
    delta[i] = qi < a.sq ? a.delta[row0 + qi] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = a.causal ? min(q0 + DQ_BM, a.sk) : a.sk;
  const int nk = (kv_end + DQ_BN - 1) / DQ_BN;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * DQ_BN;
    __syncthreads();  // the previous tile's ks/vs/dss are no longer read
    load_rows<D, DQ_BN>(ks, kp, a.k_st.s, k0, a.sk, 1.f);
    load_rows<D, DQ_BN>(vs, vp, a.v_st.s, k0, a.sk, 1.f);
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[2], vv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
        gv[i] = dos[(ty + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
        vv[j] = vs[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = q0 + ty + 16 * i, ki = k0 + tx + 16 * j;
        const float p = kept(qi, ki, a.sq, a.sk, a.causal) ? expf(s[i][j] - lse[i]) : 0.f;
        dss[(ty + 16 * i) * (DQ_BN + 1) + tx + 16 * j] = p * (dp[i][j] - delta[i]);
      }
    __syncthreads();

#pragma unroll 4
    for (int n = 0; n < DQ_BN; ++n) {
      float dsv[4], kk[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * (DQ_BN + 1) + n];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kk[j] = ks[n * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi < a.sq) {
      float* out = static_cast<float*>(a.dq) + b * a.dq_st.b + h * a.dq_st.h + qi * a.dq_st.s;
#pragma unroll
      for (int j = 0; j < DJ; ++j) out[tx + 16 * j] = acc[i][j] * a.scale;
    }
  }
}

template <int D>
constexpr int dkv_smem_floats() {
  return 2 * DKV_BK * (D + 1) + 2 * DKV_BQ * (D + 1) + DKV_BK * (DKV_BQ + 1) + 2 * DKV_BQ;
}

// dK/dV pass: one CTA per (64-row key tile, KV head, batch); loops over the
// KV head's group of query heads and, for each, over the query tiles from
// the diagonal on. A key tile that no query sees is written as zeros.
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(FlashBwdArgs a) {
  extern __shared__ float smem[];
  float* ks = smem;                        // [BK][D+1]
  float* vs = ks + DKV_BK * (D + 1);       // [BK][D+1]
  float* qs = vs + DKV_BK * (D + 1);       // [BQ][D+1], q * scale
  float* dos = qs + DKV_BQ * (D + 1);      // [BQ][D+1], dO
  float* buf = dos + DKV_BQ * (D + 1);     // [BK][BQ+1], P^T, then dS^T
  float* lse_s = buf + DKV_BK * (DKV_BQ + 1);  // [BQ]
  float* delta_s = lse_s + DKV_BQ;             // [BQ]

  constexpr int DJ = D / 16;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * DKV_BK;  // causal: the first key tiles see the most queries
  const int hk = blockIdx.y, b = blockIdx.z;

  const float* kp = static_cast<const float*>(a.k) + b * a.k_st.b + hk * a.k_st.h;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_st.b + hk * a.v_st.h;
  load_rows<D, DKV_BK>(ks, kp, a.k_st.s, k0, a.sk, 1.f);
  load_rows<D, DKV_BK>(vs, vp, a.v_st.s, k0, a.sk, 1.f);

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // k0 is a multiple of BQ: under the causal mask no query row before k0
  // sees this tile
  const int q_start = a.causal ? k0 : 0;
  for (int g = 0; g < a.group; ++g) {
    const int h = hk * a.group + g;
    const float* qp = static_cast<const float*>(a.q) + b * a.q_st.b + h * a.q_st.h;
    const float* dop = static_cast<const float*>(a.dout) + b * a.do_st.b + h * a.do_st.h;
    const int64_t row0 = (static_cast<int64_t>(b) * a.h + h) * a.sq;
    for (int q0 = q_start; q0 < a.sq; q0 += DKV_BQ) {
      __syncthreads();  // the previous tile's qs/dos/buf/lse_s are no longer read
      load_rows<D, DKV_BQ>(qs, qp, a.q_st.s, q0, a.sq, a.scale);
      load_rows<D, DKV_BQ>(dos, dop, a.do_st.s, q0, a.sq, 1.f);
      if (tid < DKV_BQ) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < a.sq ? a.lse[row0 + qi] : 0.f;
        delta_s[tid] = qi < a.sq ? a.delta[row0 + qi] : 0.f;
      }
      __syncthreads();

      // rows: key rows ty + 16 i of this CTA; columns: query rows tx + 16 j
      float s[4][2], dp[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[2], gv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = ks[(ty + 16 * i) * (D + 1) + d];
          vv[i] = vs[(ty + 16 * i) * (D + 1) + d];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          qv[j] = qs[(tx + 16 * j) * (D + 1) + d];
          gv[j] = dos[(tx + 16 * j) * (D + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }

      // s becomes P, dp becomes dS
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ki = k0 + ty + 16 * i, c = tx + 16 * j;
          const float p = kept(q0 + c, ki, a.sq, a.sk, a.causal) ? expf(s[i][j] - lse_s[c]) : 0.f;
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - delta_s[c]);
          buf[(ty + 16 * i) * (DKV_BQ + 1) + c] = p;
        }
      __syncthreads();
#pragma unroll 4
      for (int n = 0; n < DKV_BQ; ++n) {  // dV += P^T dO
        float pv[4], gg[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = buf[(ty + 16 * i) * (DKV_BQ + 1) + n];
#pragma unroll
        for (int j = 0; j < DJ; ++j) gg[j] = dos[n * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) dv[i][j] = fmaf(pv[i], gg[j], dv[i][j]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) buf[(ty + 16 * i) * (DKV_BQ + 1) + tx + 16 * j] = dp[i][j];
      __syncthreads();
#pragma unroll 4
      for (int n = 0; n < DKV_BQ; ++n) {  // dK += dS^T (q * scale)
        float dsv[4], qq[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = buf[(ty + 16 * i) * (DKV_BQ + 1) + n];
#pragma unroll
        for (int j = 0; j < DJ; ++j) qq[j] = qs[n * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) dk[i][j] = fmaf(dsv[i], qq[j], dk[i][j]);
      }
    }
  }

  // q was pre-scaled, so dK already carries the one factor of scale
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty + 16 * i;
    if (ki < a.sk) {
      float* dkp = static_cast<float*>(a.dk) + b * a.dk_st.b + hk * a.dk_st.h + ki * a.dk_st.s;
      float* dvp = static_cast<float*>(a.dv) + b * a.dv_st.b + hk * a.dv_st.h + ki * a.dv_st.s;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dkp[tx + 16 * j] = dk[i][j];
        dvp[tx + 16 * j] = dv[i][j];
      }
    }
  }
}

template <int D>
int launch_dq(const FlashBwdArgs& a, int batch, cudaStream_t stream) {
  constexpr int smem = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + DQ_BM - 1) / DQ_BM, a.h, batch);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const FlashBwdArgs& a, int batch, cudaStream_t stream) {
  constexpr int smem = dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sk + DKV_BK - 1) / DKV_BK, a.h / a.group, batch);
  flash_bwd_dkv_kernel<D><<<grid, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Strides strides_at(const int64_t* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

}  // namespace

// Plain C entry points, for float32 inputs. `strides` holds [batch,
// sequence, head] strides in elements for each tensor in argument order
// (dq pass: q, k, v, dout, dq; dk/dv pass: q, k, v, dout, dk, dv). Each
// returns a cudaError_t value: 0 when the launch was accepted.
extern "C" int ray_tpu_torch_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    const int64_t* strides, float scale, int causal, void* stream) {
  FlashBwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta; a.dq = dq;
  a.q_st = strides_at(strides, 0); a.k_st = strides_at(strides, 1);
  a.v_st = strides_at(strides, 2); a.do_st = strides_at(strides, 3);
  a.dq_st = strides_at(strides, 4);
  a.sq = sq; a.sk = sk; a.h = heads; a.group = heads / kv_heads;
  a.scale = scale; a.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch_dq<32>(a, batch, s);
    case 64: return launch_dq<64>(a, batch, s);
    case 128: return launch_dq<128>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int ray_tpu_torch_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    const int64_t* strides, float scale, int causal, void* stream) {
  FlashBwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dk = dk; a.dv = dv;
  a.q_st = strides_at(strides, 0); a.k_st = strides_at(strides, 1);
  a.v_st = strides_at(strides, 2); a.do_st = strides_at(strides, 3);
  a.dk_st = strides_at(strides, 4); a.dv_st = strides_at(strides, 5);
  a.sq = sq; a.sk = sk; a.h = heads; a.group = heads / kv_heads;
  a.scale = scale; a.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch_dkv<32>(a, batch, s);
    case 64: return launch_dkv<64>(a, batch, s);
    case 128: return launch_dkv<128>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
