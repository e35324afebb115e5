// Declarations shared by the host library (host.cpp), its own decoders
// (jpeg_host.cpp; bmp_pnm_host.cpp, tiff_host.cpp with ccitt_host.cpp and
// sgilog_host.cpp, webp_host.cpp, gif_host.cpp, raster_host.cpp,
// float_host.cpp, j2k_host.cpp with j2k_ht_host.cpp and avif_host.cpp with
// av1_*.cpp for the files the
// JAX loader hands to cv2; its encoders are encode_host.cpp and j2k_encode_host.cpp) and its
// JPEG back end: jpeg_libjpeg.cpp where the machine has libjpeg,
// jpeg_nvjpeg.cpp where it has only the CUDA toolkit's nvJPEG
// (native/__init__.py picks one at build time).
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace sdt {

// status codes of every decode and load call; native/__init__.py names them
enum Status {
  kOk = 0,
  kUnknownFormat = 1,  // no format the library or cv2 reads
  kCorrupt = 2,        // damaged or truncated data
  kUnsupported = 3,    // a valid file of a kind not decoded (a format or
                       // variant not ported, or one cv2 refuses too)
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
// checks every JPEG the host decoders do not take so before the back end
// decodes it: nvJPEG decodes a damaged stream without complaint, and
// libjpeg's fast path lets a bad code pass.
int jpeg_check(const uint8_t* d, long n);

// The library's own decoders (jpeg_host.cpp), on either back end: the
// kind of decoder that takes a stream, from its headers up to the first
// scan. Every kind needs 8 bits, one frame with a size, integer sampling
// ratios and a colour space libjpeg's guess gives RGB for (gray, YCbCr,
// RGB), or CMYK / YCCK (turned to RGB as cv2.imread turns them); kOther
// for the rest (12 bits, lossless, two components, fractional ratios).
enum JpegKind {
  kOther = 0,
  kSequential = 1,        // Huffman, SOF0 / SOF1
  kProgressive = 2,       // Huffman, SOF2
  kSequentialArith = 3,   // arithmetic, SOF9
  kProgressiveArith = 4,  // arithmetic, SOF10
  kLossless = 5,          // Huffman lossless, SOF3, of the streams cv2 reads
};
int jpeg_host_kind(const uint8_t* d, long n);
// libjpeg's colour space guess for a stream the host decoders take
// ("gray", "YCbCr", "RGB", "CMYK", "YCCK"), else nullptr
const char* jpeg_host_colour(const uint8_t* d, long n);
// (h, w) of the decoded picture of such a stream (CMYK and YCCK turned by
// their EXIF orientation, as cv2 turns them); kUnsupported for another
int jpeg_host_info(const uint8_t* d, long n, int* h, int* w);
// libjpeg's default decode of a stream of that kind into out (h, w, 3)
// RGB, bit for bit; checked as it decodes (every fault libjpeg warns of
// fails). Another kind of stream gives kUnsupported.
int jpeg_decode_sequential(const uint8_t* d, long n, uint8_t* out, int h,
                           int w);
int jpeg_decode_progressive(const uint8_t* d, long n, uint8_t* out, int h,
                            int w);
// either arithmetic kind
int jpeg_decode_arithmetic(const uint8_t* d, long n, uint8_t* out, int h,
                           int w);
// any kind the host decoders take
int jpeg_decode_host(const uint8_t* d, long n, uint8_t* out, int h, int w);
// why cv2 (and so the JAX loader) refuses a stream the host decoders do
// not take: a precision other than 8 bits in a DCT frame, or a lossless
// stream of more than 8 bits or one needing a colour conversion; nullptr
// for any other stream
const char* jpeg_refusal(const uint8_t* d, long n);

// libjpeg's input stage for a 4:2:0 stream: RGB (h, w, 3) -> y (h, w), and
// cb and cr ((h + 1) / 2, (w + 1) / 2) by the fixed-point tables of
// jccolor.c and the 2x2 means of jcsample.c (the edges repeated). The
// nvJPEG back end encodes these planes, so its pixels differ from
// libjpeg's only by the DCT.
void rgb_to_ycc420(const uint8_t* rgb, int h, int w, uint8_t* y, uint8_t* cb,
                   uint8_t* cr);

// JPEG back end, for the streams jpeg_host_kind refuses (sdt_decode's
// route, after jpeg_check) and for the tests and timings. Decode writes
// (h, w, 3) RGB of a stream jpeg_check passed: a grayscale stream is
// repeated over three channels; CMYK and YCCK streams are refused.
int jpeg_info(const uint8_t* data, long size, int* h, int* w);
int jpeg_decode(const uint8_t* data, long size, uint8_t* out, int h, int w);
// the quality of every JPEG the library writes (cv2.imwrite's default)
constexpr int kJpegQuality = 95;
// RGB (h, w, 3) -> a 4:2:0 JPEG stream at kJpegQuality, in a malloc'd
// buffer the caller frees
int jpeg_encode(const uint8_t* rgb, int h, int w, uint8_t** out, long* size);
const char* jpeg_backend();

// The files the JAX loader hands to cv2, decoded by the library itself to
// cv2.imread's pixels (IMREAD_COLOR, BGR turned to RGB): each format's
// signature test, its (h, w) as decoded, and its decode into out (h, w, 3)
// RGB. A valid file cv2 refuses too gives kUnsupported; damage, kCorrupt.
bool is_bmp(const uint8_t* d, long n);    // bmp_pnm_host.cpp
int bmp_info(const uint8_t* d, long n, int* h, int* w);
int bmp_decode(const uint8_t* d, long n, uint8_t* out, int h, int w);
bool is_pnm(const uint8_t* d, long n);    // P1-P6
int pnm_info(const uint8_t* d, long n, int* h, int* w);
int pnm_decode(const uint8_t* d, long n, uint8_t* out, int h, int w);
bool is_tiff(const uint8_t* d, long n);   // tiff_host.cpp
int tiff_info(const uint8_t* d, long n, int* h, int* w);
int tiff_decode(const uint8_t* d, long n, uint8_t* out, int h, int w);
bool is_webp(const uint8_t* d, long n);   // webp_host.cpp
int webp_info(const uint8_t* d, long n, int* h, int* w);
int webp_decode(const uint8_t* d, long n, uint8_t* out, int h, int w);
bool is_pam(const uint8_t* d, long n);    // bmp_pnm_host.cpp, P7
int pam_info(const uint8_t* d, long n, int* h, int* w);
int pam_decode(const uint8_t* d, long n, uint8_t* out, int h, int w);
bool is_gif(const uint8_t* d, long n);    // gif_host.cpp
int gif_info(const uint8_t* d, long n, int* h, int* w);
int gif_decode(const uint8_t* d, long n, uint8_t* out, int h, int w);
bool is_sun_raster(const uint8_t* d, long n);  // raster_host.cpp
int sun_raster_info(const uint8_t* d, long n, int* h, int* w);
int sun_raster_decode(const uint8_t* d, long n, uint8_t* out, int h, int w);
bool is_pfm(const uint8_t* d, long n);    // float_host.cpp
int pfm_info(const uint8_t* d, long n, int* h, int* w);
int pfm_decode(const uint8_t* d, long n, uint8_t* out, int h, int w);
bool is_hdr(const uint8_t* d, long n);
int hdr_info(const uint8_t* d, long n, int* h, int* w);
int hdr_decode(const uint8_t* d, long n, uint8_t* out, int h, int w);
bool is_jpeg2000(const uint8_t* d, long n);  // j2k_host.cpp: JP2, .j2k
int jpeg2000_info(const uint8_t* d, long n, int* h, int* w);
int jpeg2000_decode(const uint8_t* d, long n, uint8_t* out, int h, int w);
bool is_avif(const uint8_t* d, long n);  // avif_host.cpp: lossless AV1
int avif_info(const uint8_t* d, long n, int* h, int* w);
int avif_decode(const uint8_t* d, long n, uint8_t* out, int h, int w);

// One high-throughput code-block of a JPEG 2000 tile (j2k_ht_host.cpp) as
// OpenJPEG 2.5's opj_t1_ht_decode_cblk decodes it: its data (len bytes,
// every layer's contribution in packet order), the passes and lengths of
// its first nsegs codeword segments, the band's bit-planes mb (0 for a
// block never included), its own numbps (mb less the zero bit-planes),
// the component's ROI shift and VSC, into out (w x h, zeroed) at twice the
// coefficient, as Part 1's tier-1 leaves it. kHtOk, else kHtDamaged or
// kHtRefused (what OpenJPEG does not decode) with the fault in *msg.
enum { kHtOk = 0, kHtDamaged = 1, kHtRefused = 2 };
int j2k_ht_decode_cblk(const uint8_t* data, long len, const int* seg_passes,
                       const long* seg_lens, int nsegs, int mb, int numbps,
                       int roishift, bool vsc, int w, int h, int32_t* out,
                       std::string* msg);

// A CCITT strip or tile of a TIFF (ccitt_host.cpp): compression 2, 3 (with
// its T4Options) or 4, `rows` rows of `width` pixels into out as packed
// bits (1 black), as libtiff's fax decoders give them; kCorrupt (the fault
// set) on damage.
int ccitt_decode(const uint8_t* src, long len, int compression,
                 uint32_t t4_options, long width, long rows, uint8_t* out);

// An SGILog strip or tile of a TIFF (sgilog_host.cpp): `rows` rows of
// `width` pixels of LogL (kind kSgiLogL, compression 34676) into 8-bit gray,
// or of LogLuv 32 or 24 (34676 or 34677) into 8-bit RGB, as libtiff's
// tif_luv.c gives them to its RGBA reader; kCorrupt (the fault set) where
// the data ends before the rows do.
enum { kSgiLogL = 1, kSgiLogLuv32 = 2, kSgiLogLuv24 = 3 };
int sgilog_decode(const uint8_t* src, long len, int kind, long width,
                  long rows, uint8_t* out);

// (h, w) of a picture of (h, w) after the EXIF orientation o (1-8), and
// the RGB picture (h, w, 3) turned as OpenCV's ApplyExifOrientation turns it
// (flips, and for 5-8 a transpose first) into out
void oriented_size(int o, int h, int w, int* oh, int* ow);
void orient(const uint8_t* img, int h, int w, int o, uint8_t* out);

// A JPEG stream of a TIFF strip or tile (JPEGTables merged in by the
// caller), decoded by the host decoders at its own size into *out with the
// colour conversion the TIFF's photometric asks for instead of libjpeg's
// guess: ycbcr, YCbCr to RGB (h, w, 3); else none, (h, w, *ncomp) of the
// components as they are. *h0, *v0: the first component's sampling
// factors (0 where another component is not 1x1, which libtiff refuses).
int jpeg_decode_tiff(const uint8_t* d, long n, bool ycbcr,
                     std::vector<uint8_t>* out, int* h, int* w, int* ncomp,
                     int* h0, int* v0);

}  // namespace sdt
