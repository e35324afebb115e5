// The serving runner: a process without Python that runs the detector's
// packaged program (tools/export_model.py --package) on packed requests.
//
// It loads the MSDA operator library (msda_op.cpp) with dlopen, so that
// the package's calls of semi_detr::ms_deform_attn find the C++ operator,
// loads the package with libtorch's AOTIModelPackageLoader, runs every
// request once with the operator's launch counts set to 0 before and read
// after, then times REPS rounds over the requests, and writes the outputs.
// tools/serve_runner.py builds it (g++ against libtorch, libtorch_cuda
// linked whether or not a symbol of it is used: without it the CUDA
// backend is not registered and the operator cannot dispatch) and drives
// it; the binary links no libpython.
//
// Usage: sdt_serve PACKAGE OP_LIBRARY REQUESTS OUTPUTS DEVICE REPS
//   OP_LIBRARY  the operator library's path, or "-" for none
//   DEVICE      the package's device and the requests' ("cuda", "cpu")
//
// REQUESTS, little-endian:
//   "SDTREQ1\0" (8 bytes); int32 count R, batch B, height H, width W;
//   then R times: B*H*W*3 uint8 images (as api.Predictor.preprocess packs
//   them, zero beyond each image) and B*2 int32 img_hw.
// OUTPUTS, little-endian:
//   "SDTOUT1\0"; int32 R, int32 K (outputs per request: boxes, scores,
//   labels); then R*K times: int32 dtype code (0 float32, 1 int32, 2
//   int64), int32 ndim, int64 sizes[ndim], the data in C order.
// Standard output, one JSON line: the package's load seconds, each
// request's MSDA launches by instance width, warm ms per request over REPS
// rounds.
#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

#include <dlfcn.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

double seconds_since(Clock::time_point t0) {
  return std::chrono::duration<double>(Clock::now() - t0).count();
}

struct Request {
  at::Tensor images, img_hw;
};

std::vector<Request> read_requests(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) throw std::runtime_error("cannot open " + path);
  char magic[8];
  int32_t head[4];
  f.read(magic, 8);
  f.read(reinterpret_cast<char*>(head), sizeof(head));
  if (!f || std::memcmp(magic, "SDTREQ1\0", 8) != 0)
    throw std::runtime_error(path + ": not a request file");
  const int64_t r = head[0], b = head[1], h = head[2], w = head[3];
  std::vector<Request> reqs;
  for (int64_t i = 0; i < r; ++i) {
    Request q{at::empty({b, h, w, 3}, at::kByte), at::empty({b, 2}, at::kInt)};
    f.read(static_cast<char*>(q.images.data_ptr()), q.images.nbytes());
    f.read(static_cast<char*>(q.img_hw.data_ptr()), q.img_hw.nbytes());
    if (!f) throw std::runtime_error(path + ": ends before request " +
                                     std::to_string(i));
    reqs.push_back(q);
  }
  return reqs;
}

int32_t dtype_code(at::ScalarType t) {
  switch (t) {
    case at::kFloat: return 0;
    case at::kInt: return 1;
    case at::kLong: return 2;
    default: throw std::runtime_error("an output of an unexpected dtype");
  }
}

void write_outputs(const std::string& path,
                   const std::vector<std::vector<at::Tensor>>& outs) {
  std::ofstream f(path, std::ios::binary);
  const int32_t head[2] = {static_cast<int32_t>(outs.size()),
                           static_cast<int32_t>(outs.empty() ? 0
                                                : outs[0].size())};
  f.write("SDTOUT1\0", 8);
  f.write(reinterpret_cast<const char*>(head), sizeof(head));
  for (const auto& run : outs) {
    for (const auto& t0 : run) {
      const at::Tensor t = t0.contiguous();
      const int32_t meta[2] = {dtype_code(t.scalar_type()),
                               static_cast<int32_t>(t.dim())};
      f.write(reinterpret_cast<const char*>(meta), sizeof(meta));
      for (int64_t s : t.sizes())
        f.write(reinterpret_cast<const char*>(&s), sizeof(s));
      f.write(static_cast<const char*>(t.data_ptr()), t.nbytes());
    }
  }
  if (!f) throw std::runtime_error("cannot write " + path);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 7) {
    std::cerr << "usage: " << argv[0]
              << " PACKAGE OP_LIBRARY REQUESTS OUTPUTS DEVICE REPS\n";
    return 2;
  }
  const std::string package = argv[1], op_library = argv[2],
                    requests = argv[3], outputs = argv[4];
  const c10::Device device(argv[5]);
  const int reps = std::stoi(argv[6]);
  try {
    using Launches = long long (*)(int);
    using Reset = void (*)();
    Launches launches = nullptr;
    Reset reset = nullptr;
    if (op_library != "-") {
      void* lib = dlopen(op_library.c_str(), RTLD_NOW | RTLD_GLOBAL);
      if (!lib)
        throw std::runtime_error(std::string("dlopen: ") + dlerror());
      launches = reinterpret_cast<Launches>(dlsym(lib, "sdt_msda_op_launches"));
      reset = reinterpret_cast<Reset>(dlsym(lib, "sdt_msda_op_reset"));
      if (!launches || !reset)
        throw std::runtime_error(op_library + ": no launch counts");
    }
    const auto sync = [&] {
      if (device.is_cuda()) torch::cuda::synchronize();
    };
    auto t0 = Clock::now();
    torch::inductor::AOTIModelPackageLoader loader(package);
    const double load_s = seconds_since(t0);

    std::vector<std::vector<at::Tensor>> inputs;
    for (const auto& q : read_requests(requests))
      inputs.push_back({q.images.to(device), q.img_hw.to(device)});
    std::vector<std::vector<at::Tensor>> outs;
    std::ostringstream runs;
    for (size_t i = 0; i < inputs.size(); ++i) {
      if (reset) reset();
      auto got = loader.run(inputs[i]);
      sync();
      std::vector<at::Tensor> host;
      for (const auto& t : got) host.push_back(t.cpu());
      outs.push_back(host);
      runs << (i ? ", " : "") << "{\"launches\": {";
      const int widths[3] = {1, 4, 8};
      for (int k = 0; k < 3; ++k)
        runs << (k ? ", " : "") << "\"" << widths[k]
             << "\": " << (launches ? launches(widths[k]) : 0);
      runs << "}}";
    }
    write_outputs(outputs, outs);

    sync();
    t0 = Clock::now();
    for (int r = 0; r < reps; ++r)
      for (const auto& in : inputs) loader.run(in);
    sync();
    const double warm_ms = seconds_since(t0) * 1e3 /
                           (reps * static_cast<double>(inputs.size()));
    std::printf("{\"load_s\": %.6f, \"runs\": [%s], \"warm_ms\": %.6f, "
                "\"reps\": %d, \"device\": \"%s\"}\n",
                load_s, runs.str().c_str(), warm_ms, reps,
                device.str().c_str());
  } catch (const std::exception& e) {
    std::cerr << "sdt_serve: " << e.what() << "\n";
    return 1;
  }
  return 0;
}
