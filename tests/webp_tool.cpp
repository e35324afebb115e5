// Test helper: the machine's libwebp as a second witness of the host
// library's WebP decoder, beside cv2.
//
//   webp_tool decode IN OUT
//     IN decoded by WebPDecodeRGB (libwebp's defaults: fancy upsampling,
//     the loop filter on), its width and height written to OUT as two
//     32-bit little-endian integers, then its RGB bytes.
//
// Built with g++ by tests/test_torch_webp.py; exits 1 when libwebp refuses
// the file.

#include <cstdint>
#include <cstdio>
#include <string_view>
#include <vector>

#include <webp/decode.h>

int main(int argc, char** argv) {
  if (argc != 4 || std::string_view(argv[1]) != "decode") {
    std::fprintf(stderr, "usage: webp_tool decode IN OUT\n");
    return 2;
  }
  std::FILE* f = std::fopen(argv[2], "rb");
  if (!f) return 1;
  std::vector<uint8_t> buf;
  uint8_t chunk[65536];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof(chunk), f)) > 0)
    buf.insert(buf.end(), chunk, chunk + got);
  std::fclose(f);
  int w = 0, h = 0;
  uint8_t* rgb = WebPDecodeRGB(buf.data(), buf.size(), &w, &h);
  if (!rgb) {
    std::fprintf(stderr, "libwebp refuses %s\n", argv[2]);
    return 1;
  }
  std::FILE* o = std::fopen(argv[3], "wb");
  const int32_t size[2] = {w, h};
  std::fwrite(size, sizeof(size), 1, o);
  std::fwrite(rgb, 1, static_cast<size_t>(w) * h * 3, o);
  std::fclose(o);
  WebPFree(rgb);
  return 0;
}
