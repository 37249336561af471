// PyTorch binding of the port's CUDA kernels, built by
// torch.utils.cpp_extension.load together with csrc/*.cu (the only file
// that includes torch/extension.h). Each entry launches on PyTorch's
// current stream of the inputs' device and raises on a refused launch.
// Device, dtype, shape and contiguity are checked by the Python wrappers
// in daft_tpu_torch/device/hash_kernels.py.

#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <vector>

extern "C" int daft_hash_agg_build(
    const long long* w0, const long long* w1, const unsigned char* live,
    long long C, int n_words, int T, unsigned long long* tk0,
    unsigned long long* tk1, int* state, int* frow, int* info, int n_specs,
    const int* kinds, const int* vtypes, const int* ptypes,
    const unsigned long long* val_ptrs,
    const unsigned long long* contrib_ptrs,
    const unsigned long long* plane_ptrs, void* stream);

namespace {

unsigned long long addr(const at::Tensor& t) {
  return reinterpret_cast<unsigned long long>(t.data_ptr());
}

// One table build: per spec i, kinds/vtypes/ptypes[i] describe how
// vals[i] (masked by contribs[i]) accumulates into planes[i].
void hash_agg_build(const std::vector<at::Tensor>& words,
                    const at::Tensor& live, int64_t T,
                    const std::vector<at::Tensor>& tk,
                    const at::Tensor& state, const at::Tensor& frow,
                    const at::Tensor& info,
                    const std::vector<int64_t>& kinds,
                    const std::vector<int64_t>& vtypes,
                    const std::vector<int64_t>& ptypes,
                    const std::vector<at::Tensor>& vals,
                    const std::vector<at::Tensor>& contribs,
                    const std::vector<at::Tensor>& planes) {
  const c10::cuda::CUDAGuard guard(live.device());
  const size_t n = kinds.size();
  TORCH_CHECK(vtypes.size() == n && ptypes.size() == n && vals.size() == n &&
                  contribs.size() == n && planes.size() == n,
              "hash_agg_build: one kind, type, value, contrib and plane per spec");
  TORCH_CHECK(words.size() == tk.size(), "hash_agg_build: key word count");
  std::vector<int> k(kinds.begin(), kinds.end()), v(vtypes.begin(), vtypes.end()),
      p(ptypes.begin(), ptypes.end());
  std::vector<unsigned long long> vp, cp, pp;
  for (size_t i = 0; i < n; ++i) {
    vp.push_back(addr(vals[i]));
    cp.push_back(addr(contribs[i]));
    pp.push_back(addr(planes[i]));
  }
  const bool two = words.size() == 2;
  const int rc = daft_hash_agg_build(
      static_cast<const long long*>(words[0].data_ptr()),
      two ? static_cast<const long long*>(words[1].data_ptr()) : nullptr,
      static_cast<const unsigned char*>(live.data_ptr()), live.numel(),
      static_cast<int>(words.size()), static_cast<int>(T),
      static_cast<unsigned long long*>(tk[0].data_ptr()),
      two ? static_cast<unsigned long long*>(tk[1].data_ptr()) : nullptr,
      state.data_ptr<int>(), frow.data_ptr<int>(), info.data_ptr<int>(),
      static_cast<int>(n), k.data(), v.data(), p.data(), vp.data(),
      cp.data(), pp.data(), c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(rc == 0, "hash_agg_build: arguments refused (", rc, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("hash_agg_build", &hash_agg_build,
        "hash grouped-agg table build (csrc/hash_agg.cu)");
}
