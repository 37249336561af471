// PyTorch binding of the port's CUDA kernels, built by
// torch.utils.cpp_extension.load together with csrc/*.cu (the only file
// that includes torch/extension.h). Each entry launches on PyTorch's
// current stream of the inputs' device and raises on a refused launch.
// Device, dtype, shape and contiguity are checked by the Python wrappers
// in daft_tpu_torch/device/hash_kernels.py and device/join_kernels.py,
// which also allocate every output and scratch plane.

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

extern "C" int daft_hash_join_build_claim(const long long* code,
                                          const unsigned char* live,
                                          long long C, int T, long long* tk,
                                          int* cnt, int* slot_of, int* info,
                                          void* stream);
extern "C" int daft_hash_join_build_scatter(const int* slot_of, long long C,
                                            int T, const int* off, int* fill,
                                            int* rows, int* long_list,
                                            int* info, void* stream);
extern "C" int daft_hash_join_probe_count(const long long* code,
                                          const unsigned char* live,
                                          long long C, int T,
                                          const long long* tk, const int* off,
                                          int* pslot, int* counts,
                                          void* stream);
extern "C" int daft_hash_join_probe_emit(const int* pslot, const int* counts,
                                         const long long* incl, long long C,
                                         const int* off, const int* rows,
                                         long long cap, int* owner, int* ridx,
                                         void* stream);

namespace {

unsigned long long addr(const at::Tensor& t) {
  return reinterpret_cast<unsigned long long>(t.data_ptr());
}

// int64 planes as the kernels' long long (int64_t is long here)
long long* i64(const at::Tensor& t) {
  return static_cast<long long*>(t.data_ptr());
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

// Hash-join build (csrc/hash_join.cu): claim/count, the exclusive scan of
// the per-slot counts into off[1:] (torch cumsum, glue between the
// launches), then scatter and segment sort.
void hash_join_build(const at::Tensor& code, const at::Tensor& live,
                     int64_t T, const at::Tensor& tk, const at::Tensor& cnt,
                     const at::Tensor& off, const at::Tensor& slot_of,
                     const at::Tensor& fill, const at::Tensor& rows,
                     const at::Tensor& long_list, const at::Tensor& info) {
  const c10::cuda::CUDAGuard guard(code.device());
  cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  const long long C = code.numel();
  int rc = daft_hash_join_build_claim(
      i64(code),
      static_cast<const unsigned char*>(live.data_ptr()), C,
      static_cast<int>(T), i64(tk), cnt.data_ptr<int>(),
      slot_of.data_ptr<int>(), info.data_ptr<int>(), stream);
  TORCH_CHECK(rc == 0, "hash_join_build: arguments refused (", rc, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  at::Tensor scan = off.narrow(0, 1, T + 1);
  at::cumsum_out(scan, cnt, 0, at::kInt);
  rc = daft_hash_join_build_scatter(
      slot_of.data_ptr<int>(), C, static_cast<int>(T), off.data_ptr<int>(),
      fill.data_ptr<int>(), rows.data_ptr<int>(), long_list.data_ptr<int>(),
      info.data_ptr<int>(), stream);
  TORCH_CHECK(rc == 0, "hash_join_build: arguments refused (", rc, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Hash-join probe (csrc/hash_join.cu): count, the inclusive scan of the
// counts (torch cumsum), then emit into the packed [3, W] matrix's rows.
void hash_join_probe(const at::Tensor& code, const at::Tensor& live,
                     int64_t T, const at::Tensor& tk, const at::Tensor& off,
                     const at::Tensor& rows, int64_t cap,
                     const at::Tensor& packed, const at::Tensor& pslot,
                     const at::Tensor& incl) {
  const c10::cuda::CUDAGuard guard(code.device());
  cudaStream_t stream = c10::cuda::getCurrentCUDAStream().stream();
  const long long C = code.numel();
  const int64_t W = packed.size(1);
  at::Tensor counts = packed.select(0, 2).narrow(0, 0, C);
  int rc = daft_hash_join_probe_count(
      i64(code),
      static_cast<const unsigned char*>(live.data_ptr()), C,
      static_cast<int>(T), i64(tk), off.data_ptr<int>(),
      pslot.data_ptr<int>(), counts.data_ptr<int>(), stream);
  TORCH_CHECK(rc == 0, "hash_join_probe: arguments refused (", rc, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  at::Tensor scan = incl;
  at::cumsum_out(scan, counts, 0, at::kLong);
  int* base = packed.data_ptr<int>();
  rc = daft_hash_join_probe_emit(
      pslot.data_ptr<int>(), counts.data_ptr<int>(),
      i64(incl), C, off.data_ptr<int>(), rows.data_ptr<int>(),
      cap, base, base + W, stream);
  TORCH_CHECK(rc == 0, "hash_join_probe: arguments refused (", rc, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("hash_agg_build", &hash_agg_build,
        "hash grouped-agg table build (csrc/hash_agg.cu)");
  m.def("hash_join_build", &hash_join_build,
        "hash-join build: CSR table over the build keys (csrc/hash_join.cu)");
  m.def("hash_join_probe", &hash_join_probe,
        "hash-join probe: counts and pairs (csrc/hash_join.cu)");
}
