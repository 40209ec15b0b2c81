// PyTorch binding of the Hopper kernels in this directory. The only
// source of the extension that includes PyTorch's headers: the kernels
// (*.cu) have a plain C interface, so nvcc never parses torch.
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int ray_tpu_torch_flash_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
    int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    float scale, int causal, void* stream);

// The Python wrapper (ray_tpu_torch/ops/attention.py) checks devices,
// dtypes, shapes and strides before it calls this.
void flash_fwd(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               at::Tensor& o, at::Tensor& lse, double scale, bool causal) {
  const c10::cuda::CUDAGuard guard(q.device());
  const int rc = ray_tpu_torch_flash_fwd(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr<float>(),
      q.scalar_type() == at::kBFloat16 ? 1 : 0,
      q.size(0), q.size(1), k.size(1), q.size(2), k.size(2), q.size(3),
      q.stride(0), q.stride(1), q.stride(2),
      k.stride(0), k.stride(1), k.stride(2),
      v.stride(0), v.stride(1), v.stride(2),
      o.stride(0), o.stride(1), o.stride(2),
      static_cast<float>(scale), causal ? 1 : 0,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_CHECK(static_cast<cudaError_t>(rc));
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_fwd", &flash_fwd, "FlashAttention-2 forward (Hopper)");
}
