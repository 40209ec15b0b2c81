// PyTorch binding of the Hopper kernels in this directory. The only
// source of the extension that includes PyTorch's headers: the kernels
// (*.cu) have a plain C interface, so nvcc never parses torch.
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <pybind11/stl.h>

#include <map>
#include <string>

extern "C" int ray_tpu_torch_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    float scale, int causal, void* stream);

extern "C" int ray_tpu_torch_flash_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    const int64_t* strides, float scale, int causal, void* stream);

extern "C" int ray_tpu_torch_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    const int64_t* strides, float scale, int causal, void* stream);

extern "C" int ray_tpu_torch_flash_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    const int64_t* strides, float scale, int causal, void* stream);

extern "C" int ray_tpu_torch_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    const int64_t* strides, float scale, int causal, void* stream);

extern "C" int ray_tpu_torch_flash_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    const int64_t* strides, float scale, int causal, void* stream);

extern "C" const void* ray_tpu_torch_flash_fwd_sm90_kernel(int head_dim);
extern "C" const void* ray_tpu_torch_flash_bwd_dq_sm90_kernel(int head_dim);
extern "C" const void* ray_tpu_torch_flash_bwd_dkv_sm90_kernel(int head_dim);

// [batch, sequence, head] strides of each tensor, in order
static std::vector<int64_t> bsh_strides(std::initializer_list<at::Tensor> ts) {
  std::vector<int64_t> out;
  for (const auto& t : ts) {
    out.push_back(t.stride(0));
    out.push_back(t.stride(1));
    out.push_back(t.stride(2));
  }
  return out;
}

// A launcher's return code: a cudaError_t, or (tensor-core kernels) a
// tensor map cuTensorMapEncodeTiled refused (sm90_common.cuh's ERR_* codes).
static void check_rc(int rc, std::initializer_list<const char*> operands) {
  if (rc >= 200000) {
    const int idx = (rc - 200000) / 1000;
    const char* name = idx < static_cast<int>(operands.size()) ? operands.begin()[idx] : "?";
    TORCH_CHECK(false, "cuTensorMapEncodeTiled refused the TMA descriptor of ", name,
                " (CUresult ", (rc - 200000) % 1000,
                "): TMA needs a 16-byte-aligned base and batch/sequence/head strides");
  }
  TORCH_CHECK(rc != 100000, "cuTensorMapEncodeTiled could not be found in libcuda");
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

// The Python wrappers (ray_tpu_torch/ops/attention.py) check devices,
// dtypes, shapes and strides before they call these.
void flash_fwd(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               at::Tensor& o, at::Tensor& lse, double scale, bool causal) {
  const c10::cuda::CUDAGuard guard(q.device());
  const int rc = ray_tpu_torch_flash_fwd(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr<float>(),
      q.size(0), q.size(1), k.size(1), q.size(2), k.size(2), q.size(3),
      q.stride(0), q.stride(1), q.stride(2),
      k.stride(0), k.stride(1), k.stride(2),
      v.stride(0), v.stride(1), v.stride(2),
      o.stride(0), o.stride(1), o.stride(2),
      static_cast<float>(scale), causal ? 1 : 0,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

void flash_fwd_sm90(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                    at::Tensor& o, at::Tensor& lse, double scale, bool causal) {
  const c10::cuda::CUDAGuard guard(q.device());
  const auto st = bsh_strides({q, k, v, o});
  const int rc = ray_tpu_torch_flash_fwd_sm90(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr<float>(),
      q.size(0), q.size(1), k.size(1), q.size(2), k.size(2), q.size(3),
      st.data(), static_cast<float>(scale), causal ? 1 : 0,
      c10::cuda::getCurrentCUDAStream().stream());
  check_rc(rc, {"q", "k", "v"});
}

void flash_bwd_dq(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                  const at::Tensor& dout, const at::Tensor& lse, const at::Tensor& delta,
                  at::Tensor& dq, double scale, bool causal) {
  const c10::cuda::CUDAGuard guard(q.device());
  const auto st = bsh_strides({q, k, v, dout, dq});
  const int rc = ray_tpu_torch_flash_bwd_dq(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dq.data_ptr(),
      q.size(0), q.size(1), k.size(1), q.size(2), k.size(2), q.size(3),
      st.data(), static_cast<float>(scale), causal ? 1 : 0,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

void flash_bwd_dq_sm90(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                       const at::Tensor& dout, const at::Tensor& lse, const at::Tensor& delta,
                       at::Tensor& dq, double scale, bool causal) {
  const c10::cuda::CUDAGuard guard(q.device());
  const auto st = bsh_strides({q, k, v, dout, dq});
  const int rc = ray_tpu_torch_flash_bwd_dq_sm90(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dq.data_ptr(),
      q.size(0), q.size(1), k.size(1), q.size(2), k.size(2), q.size(3),
      st.data(), static_cast<float>(scale), causal ? 1 : 0,
      c10::cuda::getCurrentCUDAStream().stream());
  check_rc(rc, {"q", "k", "v", "do"});
}

void flash_bwd_dkv(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                   const at::Tensor& dout, const at::Tensor& lse, const at::Tensor& delta,
                   at::Tensor& dk, at::Tensor& dv, double scale, bool causal) {
  const c10::cuda::CUDAGuard guard(q.device());
  const auto st = bsh_strides({q, k, v, dout, dk, dv});
  const int rc = ray_tpu_torch_flash_bwd_dkv(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dk.data_ptr(), dv.data_ptr(),
      q.size(0), q.size(1), k.size(1), q.size(2), k.size(2), q.size(3),
      st.data(), static_cast<float>(scale), causal ? 1 : 0,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

void flash_bwd_dkv_sm90(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                        const at::Tensor& dout, const at::Tensor& lse, const at::Tensor& delta,
                        at::Tensor& dk, at::Tensor& dv, double scale, bool causal) {
  const c10::cuda::CUDAGuard guard(q.device());
  const auto st = bsh_strides({q, k, v, dout, dk, dv});
  const int rc = ray_tpu_torch_flash_bwd_dkv_sm90(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dk.data_ptr(), dv.data_ptr(),
      q.size(0), q.size(1), k.size(1), q.size(2), k.size(2), q.size(3),
      st.data(), static_cast<float>(scale), causal ? 1 : 0,
      c10::cuda::getCurrentCUDAStream().stream());
  check_rc(rc, {"q", "k", "v", "do"});
}

// Registers per thread at launch, static and dynamic shared memory and
// local (spill) bytes of the kernel a main path launches for bf16 inputs,
// as the runtime loaded it.
std::map<std::string, int64_t> kernel_attrs(const std::string& name, int64_t head_dim) {
  const void* kernel = nullptr;
  if (name == "flash_fwd") kernel = ray_tpu_torch_flash_fwd_sm90_kernel(head_dim);
  else if (name == "flash_bwd_dq") kernel = ray_tpu_torch_flash_bwd_dq_sm90_kernel(head_dim);
  else if (name == "flash_bwd_dkv") kernel = ray_tpu_torch_flash_bwd_dkv_sm90_kernel(head_dim);
  TORCH_CHECK(kernel != nullptr, "no kernel ", name, " for head_dim ", head_dim);
  cudaFuncAttributes fa;
  C10_CUDA_CHECK(cudaFuncGetAttributes(&fa, kernel));
  return {{"registers", static_cast<int64_t>(fa.numRegs)},
          {"static_smem_bytes", static_cast<int64_t>(fa.sharedSizeBytes)},
          {"local_bytes", static_cast<int64_t>(fa.localSizeBytes)},
          {"dynamic_smem_bytes", static_cast<int64_t>(fa.maxDynamicSharedSizeBytes)}};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_fwd", &flash_fwd, "FlashAttention-2 forward, fp32 on CUDA cores (Hopper)");
  m.def("flash_fwd_sm90", &flash_fwd_sm90,
        "FlashAttention-2 forward, bf16 on tensor cores (wgmma + TMA, sm_90a)");
  m.def("flash_bwd_dq", &flash_bwd_dq, "FlashAttention-2 backward, dQ pass, fp32 (Hopper)");
  m.def("flash_bwd_dq_sm90", &flash_bwd_dq_sm90,
        "FlashAttention-2 backward, dQ pass, bf16 on tensor cores (wgmma + TMA, sm_90a)");
  m.def("flash_bwd_dkv", &flash_bwd_dkv, "FlashAttention-2 backward, dK/dV pass, fp32 (Hopper)");
  m.def("flash_bwd_dkv_sm90", &flash_bwd_dkv_sm90,
        "FlashAttention-2 backward, dK/dV pass, bf16 on tensor cores (wgmma + TMA, sm_90a)");
  m.def("kernel_attrs", &kernel_attrs, "registers, shared memory and spill bytes of a kernel");
}
