// Declarations shared by the host library (host.cpp) and its JPEG back
// end: jpeg_libjpeg.cpp where the machine has libjpeg, jpeg_nvjpeg.cpp
// where it has only the CUDA toolkit's nvJPEG (native/__init__.py picks
// one at build time).
#pragma once

#include <cstdint>
#include <string>

namespace sdt {

// status codes of every decode and load call; native/__init__.py names them
enum Status {
  kOk = 0,
  kUnknownFormat = 1,  // neither a JPEG nor a PNG stream
  kCorrupt = 2,        // damaged or truncated data
  kUnsupported = 3,    // a valid file of a kind not decoded (CMYK, 16-bit)
  kTooLarge = 4,       // more pixels than the caller allows
  kSizeMismatch = 6,   // the stream's size is not the one the caller gave
  kDevice = 7,         // a CUDA or nvJPEG call failed
  kOpen = 10,          // the file cannot be opened
  kRead = 11,          // the file cannot be read to its end
};

// the message of the last failed call on this thread (sdt_last_error)
void set_error(const std::string& msg);

// libjpeg's output stage for a YCbCr stream decoded to planes: fancy
// (triangle) upsampling of the chroma planes (ch x cw, subsampled by hs x
// vs, each 1 or 2) and the fixed-point YCbCr -> RGB tables, into out
// (h, w, 3). A back end whose decoder gives planes (nvJPEG) calls it, so
// its pixels differ from libjpeg's only by the IDCT.
void ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                int h, int w, int ch, int cw, int hs, int vs, uint8_t* out);

// kOk for a JPEG stream that runs whole from SOI to EOI, else kCorrupt
// with the fault (truncated, a bad Huffman code, a restart marker out of
// order): the marker segments walked, and the entropy-coded data of a
// sequential Huffman stream decoded as libjpeg decodes it. sdt_decode
// checks every JPEG so before either back end decodes it: nvJPEG decodes a
// damaged stream without complaint, and libjpeg's fast path lets a bad
// code pass.
int jpeg_check(const uint8_t* d, long n);

// true for a stream jpeg_decode_sequential takes: sequential Huffman
// (SOF0, SOF1) of 8 bits, gray or YCbCr (libjpeg's colour space guess),
// the luma at the largest sampling factors and both chroma planes subsampled
// alike by 1 or 2 in each direction. Read from the segments before the
// first scan only.
bool jpeg_sequential(const uint8_t* d, long n);

// libjpeg's default decode of such a stream, in this library: the
// entropy-coded data decoded (checked as jpeg_check checks it), dequantized,
// jidctint.c's integer IDCT (jpeg_idct_islow) and ycc_to_rgb, into out
// (h, w, 3); a gray stream is repeated over three channels. Bit-equal to
// libjpeg's decode. Another kind of stream gives kUnsupported.
int jpeg_decode_sequential(const uint8_t* d, long n, uint8_t* out, int h,
                           int w);

// libjpeg's input stage for a 4:2:0 stream: RGB (h, w, 3) -> y (h, w), and
// cb and cr ((h + 1) / 2, (w + 1) / 2) by the fixed-point tables of
// jccolor.c and the 2x2 means of jcsample.c (the edges repeated). The
// nvJPEG back end encodes these planes, so its pixels differ from
// libjpeg's only by the DCT.
void rgb_to_ycc420(const uint8_t* rgb, int h, int w, uint8_t* y, uint8_t* cb,
                   uint8_t* cr);

// JPEG back end. Decode writes (h, w, 3) RGB of a stream jpeg_check
// passed: a grayscale stream is repeated over three channels; CMYK and
// YCCK streams are refused.
int jpeg_info(const uint8_t* data, long size, int* h, int* w);
int jpeg_decode(const uint8_t* data, long size, uint8_t* out, int h, int w);
// the quality of every JPEG the library writes (cv2.imwrite's default)
constexpr int kJpegQuality = 95;
// RGB (h, w, 3) -> a 4:2:0 JPEG stream at kJpegQuality, in a malloc'd
// buffer the caller frees
int jpeg_encode(const uint8_t* rgb, int h, int w, uint8_t** out, long* size);
const char* jpeg_backend();
// true where sdt_decode gives the streams jpeg_sequential takes to
// jpeg_decode_sequential instead of the back end (nvJPEG: its IDCT is not
// libjpeg's); the libjpeg back end decodes every stream itself
bool jpeg_sequential_on_host();

}  // namespace sdt
