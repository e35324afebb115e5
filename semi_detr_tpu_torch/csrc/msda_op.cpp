// semi_detr::ms_deform_attn as a C++ operator: the MSDA forward for a
// process without Python, such as the serving runner (serve_main.cpp).
//
// A program that AOTInductor packages (tools/export_model.py,
// package_program) calls MSDA by its name through the proxy executor. In a
// Python process the name resolves to the Python operator that
// ops/ms_deform_attn_cuda.py registers; this library registers the same
// schema, letter for letter, with a CUDA kernel that calls the same
// launchers (msda_fwd_f32 / msda_fwd_bf16 of ms_deform_attn_fwd.cu, built
// by nvcc into their own library, which this one links). The kernel source
// is not copied: both routes launch one kernel.
//
// Load this library only where the Python operator is not registered: two
// definitions of one schema in one process collide (TORCH_LIBRARY raises at
// load). The runner dlopens it; a Python process imports the ops module.
//
// The kernel checks its inputs as ops/ms_deform_attn_cuda.py's
// _check_inputs does, takes the instance kernel_width takes (16 bytes of
// the value dtype per lane where D and the pointers allow, else one
// channel), launches on the current CUDA stream and raises on a CPU tensor
// or a launch error; it never falls back. Each launch is counted by the
// instance's width, read through sdt_msda_op_launches.
#include <ATen/ATen.h>
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/library.h>

#include <array>
#include <atomic>
#include <map>
#include <mutex>
#include <tuple>
#include <vector>

extern "C" int msda_fwd_f32(const void* value, const void* meta,
                            const void* loc, const void* attn, void* out,
                            int N, int S, int M, int D, int Lq, int L, int P,
                            int width, void* stream);
extern "C" int msda_fwd_bf16(const void* value, const void* meta,
                             const void* loc, const void* attn, void* out,
                             int N, int S, int M, int D, int Lq, int L,
                             int P, int width, void* stream);

namespace {

// launches by the instance's channels per lane (1, 4 or 8)
std::array<std::atomic<long long>, 9> g_launches{};

// int32 (L, 3) = (H, W, level start) on the device, cached by shapes and
// device as ops/ms_deform_attn_cuda.py's _meta caches it
at::Tensor level_meta(const std::vector<int64_t>& hw, const at::Device& dev) {
  static std::mutex mu;
  static std::map<std::tuple<std::vector<int64_t>, int>, at::Tensor> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(hw, static_cast<int>(dev.index()));
  auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  const int64_t levels = static_cast<int64_t>(hw.size()) / 2;
  auto meta = at::empty({levels, 3}, at::dtype(at::kInt));
  int32_t* m = meta.data_ptr<int32_t>();
  int64_t start = 0;
  for (int64_t l = 0; l < levels; ++l) {
    m[3 * l] = static_cast<int32_t>(hw[2 * l]);
    m[3 * l + 1] = static_cast<int32_t>(hw[2 * l + 1]);
    m[3 * l + 2] = static_cast<int32_t>(start);
    start += hw[2 * l] * hw[2 * l + 1];
  }
  meta = meta.to(dev);
  cache.emplace(key, meta);
  return meta;
}

// kernel_width: 16 bytes of the dtype per lane where D fills whole chunks,
// D / width lanes divide the warp's 32 and every pointer is 16-byte aligned
int kernel_width(int64_t d, at::ScalarType dtype,
                 std::initializer_list<const void*> ptrs) {
  const int64_t width = dtype == at::kBFloat16 ? 8 : 4;
  const int64_t lanes = d / width;
  bool aligned = true;
  for (const void* p : ptrs)
    aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  if (d % width == 0 && aligned &&
      (lanes == 1 || lanes == 2 || lanes == 4 || lanes == 8 || lanes == 16 ||
       lanes == 32))
    return static_cast<int>(width);
  return 1;
}

at::Tensor ms_deform_attn_cuda(const at::Tensor& value,
                               c10::SymIntArrayRef spatial_shapes,
                               const at::Tensor& loc,
                               const at::Tensor& attn) {
  // _check_inputs
  TORCH_CHECK(value.dim() == 4 && loc.dim() == 6 && attn.dim() == 5,
              "expected value (N,S,M,D), loc (N,Lq,M,L,P,2), attn "
              "(N,Lq,M,L,P)");
  const int64_t N = value.size(0), S = value.size(1), M = value.size(2),
                D = value.size(3);
  const int64_t Lq = loc.size(1), L = loc.size(3), P = loc.size(4);
  TORCH_CHECK(loc.sizes() == at::IntArrayRef({N, Lq, M, L, P, 2}) &&
                  attn.sizes() == at::IntArrayRef({N, Lq, M, L, P}),
              "shape mismatch: value ", value.sizes(), ", loc ", loc.sizes(),
              ", attn ", attn.sizes());
  std::vector<int64_t> hw;
  for (const auto& v : spatial_shapes)
    hw.push_back(v.guard_int(__FILE__, __LINE__));
  int64_t total = 0;
  for (size_t l = 0; l + 1 < hw.size(); l += 2) total += hw[l] * hw[l + 1];
  TORCH_CHECK(hw.size() % 2 == 0 && static_cast<int64_t>(hw.size()) == 2 * L &&
                  total == S,
              "spatial_shapes ", at::IntArrayRef(hw), " do not match L=", L,
              ", S=", S);
  const auto dtype = value.scalar_type();
  TORCH_CHECK(dtype == at::kFloat || dtype == at::kBFloat16, "value dtype ",
              dtype, " not supported");
  TORCH_CHECK(loc.scalar_type() == at::kFloat &&
                  attn.scalar_type() == at::kFloat,
              "sampling_locations and attention_weights must be float32");
  TORCH_CHECK(value.is_cuda() && loc.device() == value.device() &&
                  attn.device() == value.device(),
              "all inputs must lie on one CUDA device");
  TORCH_CHECK(value.is_contiguous() && loc.is_contiguous() &&
                  attn.is_contiguous(),
              "inputs must be contiguous");

  const c10::cuda::CUDAGuard guard(value.device());
  auto out = at::empty({N, Lq, M * D}, value.options());
  const int width =
      kernel_width(D, dtype, {value.data_ptr(), out.data_ptr()});
  const auto meta = level_meta(hw, value.device());
  void* stream =
      at::cuda::getCurrentCUDAStream(value.device().index()).stream();
  const auto launch = dtype == at::kFloat ? msda_fwd_f32 : msda_fwd_bf16;
  const int err = launch(value.data_ptr(), meta.data_ptr(), loc.data_ptr(),
                         attn.data_ptr(), out.data_ptr(), static_cast<int>(N),
                         static_cast<int>(S), static_cast<int>(M),
                         static_cast<int>(D), static_cast<int>(Lq),
                         static_cast<int>(L), static_cast<int>(P), width,
                         stream);
  TORCH_CHECK(err == 0, "MSDA forward kernel launch failed: CUDA error ", err);
  ++g_launches[width];
  return out;
}

}  // namespace

// the schema of ops/ms_deform_attn_cuda.py's semi_detr::ms_deform_attn,
// letter for letter (tests/test_torch_package.py holds the two equal)
TORCH_LIBRARY(semi_detr, m) {
  m.def(
      "ms_deform_attn(Tensor value, SymInt[] spatial_shapes, Tensor "
      "sampling_locations, Tensor attention_weights) -> Tensor");
}

TORCH_LIBRARY_IMPL(semi_detr, CUDA, m) {
  m.impl("ms_deform_attn", &ms_deform_attn_cuda);
}

// launches of the instance of `width` channels per lane since the last
// reset (width 1, 4 or 8; anything else reads 0)
extern "C" long long sdt_msda_op_launches(int width) {
  return width >= 0 && width < 9 ? g_launches[width].load() : 0;
}

extern "C" void sdt_msda_op_reset() {
  for (auto& c : g_launches) c = 0;
}
