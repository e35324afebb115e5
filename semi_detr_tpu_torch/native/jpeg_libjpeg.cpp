// JPEG back end of the host library through libjpeg, as
// semi_detr_tpu/native/dataloader.cpp decodes (sdt_decode_jpeg), for the
// streams the library's own decoders (jpeg_host.cpp) do not take: default
// settings (integer IDCT, fancy upsampling), output JCS_RGB, so a
// grayscale stream comes out as three equal channels, the pixels
// cv2.imread gives. Encode: jpeg_set_defaults at kJpegQuality (4:2:0, the
// settings of cv2.imwrite).
//
// A decode fails rather than return a filled-in image: libjpeg's warnings
// of damaged data (a truncated stream, a bad Huffman code) are errors
// here, beside host.cpp's jpeg_check; only stray bytes between markers,
// which change no pixel, pass. CMYK and YCCK streams are refused.

#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <string>

#include <jpeglib.h>
#include <jerror.h>

#include "host.h"

namespace sdt {
namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
  char msg[JMSG_LENGTH_MAX];
  bool damaged;
};

void on_error(j_common_ptr c) {
  JpegErr* e = reinterpret_cast<JpegErr*>(c->err);
  c->err->format_message(c, e->msg);
  longjmp(e->jb, 1);
}

void on_message(j_common_ptr c, int level) {
  if (level >= 0) return;  // trace messages
  JpegErr* e = reinterpret_cast<JpegErr*>(c->err);
  c->err->num_warnings++;
  if (c->err->msg_code == JWRN_EXTRANEOUS_DATA || e->damaged) return;
  e->damaged = true;
  c->err->format_message(c, e->msg);
}

void init_err(jpeg_decompress_struct* c, JpegErr* e) {
  c->err = jpeg_std_error(&e->mgr);
  e->mgr.error_exit = on_error;
  e->mgr.emit_message = on_message;
  e->damaged = false;
  e->msg[0] = 0;
}

int check_colour(const jpeg_decompress_struct& c) {
  if (c.jpeg_color_space == JCS_CMYK || c.jpeg_color_space == JCS_YCCK ||
      (c.num_components != 1 && c.num_components != 3)) {
    set_error("JPEG with " + std::to_string(c.num_components) +
              " components (CMYK or YCCK): not decoded, convert it to RGB");
    return kUnsupported;
  }
  return kOk;
}

}  // namespace

int jpeg_info(const uint8_t* data, long size, int* h, int* w) {
  jpeg_decompress_struct c;
  JpegErr e;
  init_err(&c, &e);
  if (setjmp(e.jb)) {
    jpeg_destroy_decompress(&c);
    set_error(std::string("JPEG: ") + e.msg);
    return kCorrupt;
  }
  jpeg_create_decompress(&c);
  jpeg_mem_src(&c, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&c, TRUE);
  const int st = check_colour(c);
  *h = static_cast<int>(c.image_height);
  *w = static_cast<int>(c.image_width);
  jpeg_destroy_decompress(&c);
  return st;
}

int jpeg_decode(const uint8_t* data, long size, uint8_t* out, int h, int w) {
  jpeg_decompress_struct c;
  JpegErr e;
  init_err(&c, &e);
  if (setjmp(e.jb)) {
    jpeg_destroy_decompress(&c);
    set_error(std::string("JPEG: ") + e.msg);
    return kCorrupt;
  }
  jpeg_create_decompress(&c);
  jpeg_mem_src(&c, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&c, TRUE);
  int st = check_colour(c);
  if (!st && (static_cast<int>(c.image_height) != h ||
              static_cast<int>(c.image_width) != w)) {
    set_error("JPEG size differs from the size asked for");
    st = kSizeMismatch;
  }
  if (st) {
    jpeg_destroy_decompress(&c);
    return st;
  }
  c.out_color_space = JCS_RGB;
  jpeg_start_decompress(&c);
  while (c.output_scanline < c.output_height) {
    JSAMPROW row = out + static_cast<long>(c.output_scanline) * w * 3;
    jpeg_read_scanlines(&c, &row, 1);
  }
  jpeg_finish_decompress(&c);
  jpeg_destroy_decompress(&c);
  if (e.damaged) {
    set_error(std::string("JPEG: damaged data: ") + e.msg);
    return kCorrupt;
  }
  return kOk;
}

int jpeg_encode(const uint8_t* rgb, int h, int w, uint8_t** out, long* size) {
  jpeg_compress_struct c;
  JpegErr e;
  c.err = jpeg_std_error(&e.mgr);
  e.mgr.error_exit = on_error;
  unsigned char* buf = nullptr;
  unsigned long len = 0;
  if (setjmp(e.jb)) {
    jpeg_destroy_compress(&c);
    std::free(buf);
    set_error(std::string("JPEG encode: ") + e.msg);
    return kCorrupt;
  }
  jpeg_create_compress(&c);
  jpeg_mem_dest(&c, &buf, &len);
  c.image_width = static_cast<JDIMENSION>(w);
  c.image_height = static_cast<JDIMENSION>(h);
  c.input_components = 3;
  c.in_color_space = JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, kJpegQuality, TRUE);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(
        rgb + static_cast<long>(c.next_scanline) * w * 3);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  *out = buf;
  *size = static_cast<long>(len);
  return kOk;
}

const char* jpeg_backend() { return "libjpeg"; }

}  // namespace sdt
