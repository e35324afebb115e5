// JPEG back end of the host library through nvJPEG, for a machine that has
// the CUDA toolkit but no libjpeg (the H100 machine of this port). A
// sequential or progressive Huffman stream that jpeg_host_kind takes does
// not come here: host.cpp decodes it libjpeg-exact (jpeg_host_route). Any other stream is decoded on
// the card to its Y, Cb and Cr planes, copied back to
// host memory and finished as libjpeg finishes it (fancy chroma upsampling
// and its fixed-point colour tables, host.cpp's ycc_to_rgb), so only
// nvJPEG's IDCT differs from libjpeg's; subsamplings other than 4:4:4,
// 4:2:2, 4:2:0 and 4:4:0 take nvJPEG's own RGB conversion. Encode: the
// other way round, libjpeg's colour conversion and 4:2:0 downsampling
// (host.cpp's rgb_to_ycc420), then nvJPEG's DCT and entropy coding on the
// card at kJpegQuality; nvJPEG's own RGB input reads Y half a level low.
// chip_smoke.py phase 7a holds the decode to the committed fixtures
// (native/fixtures/) and the encode + decode to cv2's within stated
// tolerances.
//
// One nvJPEG handle per process; each thread that decodes or encodes has
// its own decode state, encoder state, CUDA stream and device buffer, freed
// when the thread exits. The buffer grows geometrically through the
// stream-ordered allocator (cudaMallocAsync / cudaFreeAsync), which does
// not synchronise the device.

#include <cuda_runtime_api.h>
#include <nvjpeg.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "host.h"

namespace sdt {
namespace {

nvjpegHandle_t g_handle = nullptr;
nvjpegStatus_t g_handle_status = NVJPEG_STATUS_NOT_INITIALIZED;
std::once_flag g_once;

struct Ctx {
  bool ready = false;  // stream and decode state created
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dev = nullptr;
  size_t cap = 0;
  std::vector<uint8_t> planes;  // host copy of Y, Cb, Cr

  ~Ctx() {
    if (params) nvjpegEncoderParamsDestroy(params);
    if (enc) nvjpegEncoderStateDestroy(enc);
    if (state) nvjpegJpegStateDestroy(state);
    if (dev) cudaFreeAsync(dev, stream);
    if (stream) {
      cudaStreamSynchronize(stream);
      cudaStreamDestroy(stream);
    }
  }
};
thread_local Ctx t_ctx;

bool nvj_ok(nvjpegStatus_t s, const char* what) {
  if (s == NVJPEG_STATUS_SUCCESS) return true;
  set_error(std::string("nvJPEG ") + what + " failed: status " +
            std::to_string(static_cast<int>(s)));
  return false;
}

bool cuda_ok(cudaError_t e, const char* what) {
  if (e == cudaSuccess) return true;
  set_error(std::string("CUDA ") + what + " failed: " + cudaGetErrorString(e));
  return false;
}

nvjpegHandle_t handle() {
  std::call_once(g_once,
                 [] { g_handle_status = nvjpegCreateSimple(&g_handle); });
  if (!nvj_ok(g_handle_status, "nvjpegCreateSimple")) return nullptr;
  return g_handle;
}

// this thread's context, created at its first call
Ctx* ctx(nvjpegHandle_t h) {
  Ctx* c = &t_ctx;
  if (c->ready) return c;
  if ((!c->stream &&
       !cuda_ok(cudaStreamCreateWithFlags(&c->stream, cudaStreamNonBlocking),
                "cudaStreamCreate")) ||
      (!c->state &&
       !nvj_ok(nvjpegJpegStateCreate(h, &c->state), "nvjpegJpegStateCreate")))
    return nullptr;
  c->ready = true;
  return c;
}

// the device buffer at n bytes or more: at least twice the old size, so a
// run of growing images regrows it a few times only
bool reserve(Ctx* c, size_t n) {
  if (n <= c->cap) return true;
  const size_t cap = n > 2 * c->cap ? n : 2 * c->cap;
  if (c->dev) cudaFreeAsync(c->dev, c->stream);
  c->dev = nullptr;
  c->cap = 0;
  if (!cuda_ok(cudaMallocAsync(reinterpret_cast<void**>(&c->dev), cap,
                               c->stream),
               "cudaMallocAsync"))
    return false;
  c->cap = cap;
  return true;
}

struct Info {
  int comps = 0;
  nvjpegChromaSubsampling_t ss = NVJPEG_CSS_UNKNOWN;
  int ws[NVJPEG_MAX_COMPONENT] = {}, hs[NVJPEG_MAX_COMPONENT] = {};
};

// components, subsampling and plane sizes; CMYK and other layouts refused
int info(nvjpegHandle_t h, const uint8_t* data, long size, Info* in) {
  if (!nvj_ok(nvjpegGetImageInfo(h, data, static_cast<size_t>(size),
                                 &in->comps, &in->ss, in->ws, in->hs),
              "nvjpegGetImageInfo"))
    return kCorrupt;
  if (in->comps != 1 && in->comps != 3) {
    set_error("JPEG with " + std::to_string(in->comps) +
              " components (CMYK or YCCK): not decoded, convert it to RGB");
    return kUnsupported;
  }
  return kOk;
}

// the chroma factors (horizontal, vertical) that ycc_to_rgb finishes
bool ycc_factors(nvjpegChromaSubsampling_t ss, int* fh, int* fv) {
  switch (ss) {
    case NVJPEG_CSS_444: *fh = 1; *fv = 1; return true;
    case NVJPEG_CSS_422: *fh = 2; *fv = 1; return true;
    case NVJPEG_CSS_420: *fh = 2; *fv = 2; return true;
    case NVJPEG_CSS_440: *fh = 1; *fv = 2; return true;
    default: return false;
  }
}

}  // namespace

int jpeg_info(const uint8_t* data, long size, int* h, int* w) {
  nvjpegHandle_t hd = handle();
  if (!hd) return kDevice;
  Info in;
  const int st = info(hd, data, size, &in);
  *h = in.hs[0];
  *w = in.ws[0];
  return st;
}

int jpeg_decode(const uint8_t* data, long size, uint8_t* out, int h, int w) {
  nvjpegHandle_t hd = handle();
  Ctx* c = hd ? ctx(hd) : nullptr;
  if (!c) return kDevice;
  Info in;
  int st = info(hd, data, size, &in);
  if (st) return st;
  if (in.hs[0] != h || in.ws[0] != w) {
    set_error("JPEG size differs from the size asked for");
    return kSizeMismatch;
  }
  // planes: Y alone for a grayscale stream (repeated below), Y + Cb + Cr
  // where ycc_to_rgb can finish them, else nvJPEG's interleaved RGB
  int fh = 1, fv = 1;
  const bool gray = in.comps == 1;
  const bool planar = !gray && ycc_factors(in.ss, &fh, &fv);
  const size_t luma = static_cast<size_t>(h) * w;
  const size_t chroma = planar ? static_cast<size_t>(in.hs[1]) * in.ws[1] : 0;
  const size_t n = gray ? luma : (planar ? luma + 2 * chroma : 3 * luma);
  if (!reserve(c, n)) return kDevice;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = c->dev;
  img.pitch[0] = gray || planar ? static_cast<size_t>(w)
                                : static_cast<size_t>(w) * 3;
  if (planar) {
    for (int k = 1; k < 3; ++k) {
      img.channel[k] = c->dev + luma + (k - 1) * chroma;
      img.pitch[k] = static_cast<size_t>(in.ws[1]);
    }
  }
  const nvjpegOutputFormat_t fmt = gray ? NVJPEG_OUTPUT_Y
                                        : (planar ? NVJPEG_OUTPUT_YUV
                                                  : NVJPEG_OUTPUT_RGBI);
  const nvjpegStatus_t s =
      nvjpegDecode(hd, c->state, data, static_cast<size_t>(size), fmt, &img,
                   c->stream);
  if (!nvj_ok(s, "nvjpegDecode"))
    return s == NVJPEG_STATUS_JPEG_NOT_SUPPORTED ? kUnsupported : kCorrupt;
  uint8_t* host = out;
  if (planar) {
    c->planes.resize(n);
    host = c->planes.data();
  }
  if (!cuda_ok(cudaMemcpyAsync(host, c->dev, n, cudaMemcpyDeviceToHost,
                               c->stream),
               "cudaMemcpyAsync") ||
      !cuda_ok(cudaStreamSynchronize(c->stream), "cudaStreamSynchronize"))
    return kDevice;
  if (gray) {
    for (long i = static_cast<long>(luma) - 1; i >= 0; --i)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = out[i];
  } else if (planar) {
    ycc_to_rgb(host, host + luma, host + luma + chroma, h, w, in.hs[1],
               in.ws[1], fh, fv, out);
  }
  return kOk;
}

int jpeg_encode(const uint8_t* rgb, int h, int w, uint8_t** out, long* size) {
  nvjpegHandle_t hd = handle();
  Ctx* c = hd ? ctx(hd) : nullptr;
  if (!c) return kDevice;
  if (!c->enc) {
    if ((!c->params &&
         !nvj_ok(nvjpegEncoderParamsCreate(hd, &c->params, c->stream),
                 "nvjpegEncoderParamsCreate")) ||
        !nvj_ok(nvjpegEncoderParamsSetSamplingFactors(c->params,
                                                      NVJPEG_CSS_420,
                                                      c->stream),
                "nvjpegEncoderParamsSetSamplingFactors") ||
        !nvj_ok(nvjpegEncoderParamsSetOptimizedHuffman(c->params, 0,
                                                       c->stream),
                "nvjpegEncoderParamsSetOptimizedHuffman") ||
        !nvj_ok(nvjpegEncoderParamsSetQuality(c->params, kJpegQuality,
                                              c->stream),
                "nvjpegEncoderParamsSetQuality") ||
        !nvj_ok(nvjpegEncoderStateCreate(hd, &c->enc, c->stream),
                "nvjpegEncoderStateCreate"))
      return kDevice;
  }
  // libjpeg's colour conversion and downsampling here, nvJPEG's DCT and
  // entropy coding on the card
  const size_t luma = static_cast<size_t>(h) * w;
  const size_t cw = (w + 1) / 2, chroma = cw * ((h + 1) / 2);
  const size_t n = luma + 2 * chroma;
  c->planes.resize(n);
  uint8_t* host = c->planes.data();
  rgb_to_ycc420(rgb, h, w, host, host + luma, host + luma + chroma);
  if (!reserve(c, n)) return kDevice;
  if (!cuda_ok(cudaMemcpyAsync(c->dev, host, n, cudaMemcpyHostToDevice,
                               c->stream),
               "cudaMemcpyAsync"))
    return kDevice;
  nvjpegImage_t src;
  std::memset(&src, 0, sizeof(src));
  for (int k = 0; k < 3; ++k) {
    src.channel[k] = c->dev + (k ? luma + (k - 1) * chroma : 0);
    src.pitch[k] = k ? cw : static_cast<size_t>(w);
  }
  size_t len = 0;
  if (!nvj_ok(nvjpegEncodeYUV(hd, c->enc, c->params, &src, NVJPEG_CSS_420,
                              w, h, c->stream),
              "nvjpegEncodeYUV") ||
      !nvj_ok(nvjpegEncodeRetrieveBitstream(hd, c->enc, nullptr, &len,
                                            c->stream),
              "nvjpegEncodeRetrieveBitstream") ||
      !cuda_ok(cudaStreamSynchronize(c->stream), "cudaStreamSynchronize"))
    return kDevice;
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(len));
  if (!buf) {
    set_error("out of host memory for the JPEG stream");
    return kDevice;
  }
  if (!nvj_ok(nvjpegEncodeRetrieveBitstream(hd, c->enc, buf, &len,
                                            c->stream),
              "nvjpegEncodeRetrieveBitstream") ||
      !cuda_ok(cudaStreamSynchronize(c->stream), "cudaStreamSynchronize")) {
    std::free(buf);
    return kDevice;
  }
  *out = buf;
  *size = static_cast<long>(len);
  return kOk;
}

const char* jpeg_backend() { return "nvjpeg"; }

bool jpeg_host_route() { return true; }

}  // namespace sdt
