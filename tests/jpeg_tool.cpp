// Test helper: JPEG streams that cv2 and Pillow do not write, made with
// the machine's libjpeg (libjpeg-turbo 2.1.5 where the tests run).
//
//   jpeg_tool transcode IN OUT [arithmetic] [progressive] [restart N]
//     IN's quantized coefficients rewritten losslessly (jpeg_read_coefficients
//     -> jpeg_write_coefficients, as jpegtran does): arithmetic coding
//     (`jpegtran -arithmetic`), libjpeg's progressive scan script, a
//     restart interval of N MCUs.
//   jpeg_tool ycck RAW H W QUALITY OUT
//     RAW (H x W x 4 bytes of CMYK) encoded as a YCCK stream (Adobe
//     transform 2; libjpeg's default factors for it, Y and K 2x2).
//
// Built with g++ by tests/test_torch_jpeg_formats.py; exits 1 with
// libjpeg's message on failure.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

void on_error(j_common_ptr c) {
  char msg[JMSG_LENGTH_MAX];
  c->err->format_message(c, msg);
  std::fprintf(stderr, "libjpeg: %s\n", msg);
  std::exit(1);
}

std::vector<unsigned char> read_all(const char* path) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) {
    std::fprintf(stderr, "cannot open %s\n", path);
    std::exit(1);
  }
  std::vector<unsigned char> buf;
  unsigned char chunk[65536];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof(chunk), f)) > 0)
    buf.insert(buf.end(), chunk, chunk + got);
  std::fclose(f);
  return buf;
}

void write_all(const char* path, const unsigned char* d, unsigned long n) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f || std::fwrite(d, 1, n, f) != n) {
    std::fprintf(stderr, "cannot write %s\n", path);
    std::exit(1);
  }
  std::fclose(f);
}

int transcode(int argc, char** argv) {
  bool arith = false, prog = false;
  int restart = 0;
  for (int i = 4; i < argc; ++i) {
    if (!std::strcmp(argv[i], "arithmetic")) arith = true;
    else if (!std::strcmp(argv[i], "progressive")) prog = true;
    else if (!std::strcmp(argv[i], "restart") && i + 1 < argc)
      restart = std::atoi(argv[++i]);
  }
  std::vector<unsigned char> in = read_all(argv[2]);
  jpeg_decompress_struct src;
  jpeg_compress_struct dst;
  jpeg_error_mgr e1, e2;
  src.err = jpeg_std_error(&e1);
  e1.error_exit = on_error;
  dst.err = jpeg_std_error(&e2);
  e2.error_exit = on_error;
  jpeg_create_decompress(&src);
  jpeg_create_compress(&dst);
  jpeg_mem_src(&src, in.data(), in.size());
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr* coefs = jpeg_read_coefficients(&src);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.arith_code = arith ? TRUE : FALSE;
  dst.optimize_coding = FALSE;
  dst.restart_interval = static_cast<unsigned>(restart);
  if (prog) jpeg_simple_progression(&dst);
  unsigned char* out = nullptr;
  unsigned long size = 0;
  jpeg_mem_dest(&dst, &out, &size);
  jpeg_write_coefficients(&dst, coefs);
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  write_all(argv[3], out, size);
  std::free(out);
  return 0;
}

int ycck(char** argv) {
  std::vector<unsigned char> raw = read_all(argv[2]);
  const int h = std::atoi(argv[3]), w = std::atoi(argv[4]);
  if (raw.size() != static_cast<size_t>(h) * w * 4) {
    std::fprintf(stderr, "RAW holds %zu bytes, not %d x %d x 4\n",
                 raw.size(), h, w);
    return 1;
  }
  jpeg_compress_struct c;
  jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  e.error_exit = on_error;
  jpeg_create_compress(&c);
  unsigned char* out = nullptr;
  unsigned long size = 0;
  jpeg_mem_dest(&c, &out, &size);
  c.image_width = static_cast<JDIMENSION>(w);
  c.image_height = static_cast<JDIMENSION>(h);
  c.input_components = 4;
  c.in_color_space = JCS_CMYK;
  jpeg_set_defaults(&c);
  jpeg_set_colorspace(&c, JCS_YCCK);
  jpeg_set_quality(&c, std::atoi(argv[5]), TRUE);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = raw.data() + static_cast<size_t>(c.next_scanline) * w * 4;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  write_all(argv[6], out, size);
  std::free(out);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc >= 4 && !std::strcmp(argv[1], "transcode"))
    return transcode(argc, argv);
  if (argc == 7 && !std::strcmp(argv[1], "ycck")) return ycck(argv);
  std::fprintf(stderr,
               "usage: jpeg_tool transcode IN OUT [arithmetic] [progressive] "
               "[restart N]\n       jpeg_tool ycck RAW H W QUALITY OUT\n");
  return 2;
}
