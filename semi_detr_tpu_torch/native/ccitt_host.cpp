// CCITT fax decoders of the host library's TIFF reader (tiff_host.cpp), as
// libtiff's tif_fax3.c decodes a strip or tile: modified Huffman
// (compression 2: 1-D rows, each starting on a byte), Group 3 (3: an EOL
// before every row, found by skipping to eleven zero bits; 2-D coding, T4
// option bit 0, adds a tag bit after it, 1 for a 1-D row, 0 for a 2-D one)
// and Group 4 (4: 2-D rows against the row above, the first against a white
// row, no EOLs). The codes are ITU-T T.4's; the output is rows of packed
// bits, most significant first, 1 for a black pixel. A code that is not in
// the tables, a run past the row, the uncompressed mode (an extension code)
// or data that ends before the rows do fails.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "host.h"

namespace sdt {

namespace {

struct Code {
  int run;
  const char* bits;
};

const Code kWhite[] = {
    {0, "00110101"}, {1, "000111"}, {2, "0111"}, {3, "1000"}, {4, "1011"},
    {5, "1100"}, {6, "1110"}, {7, "1111"}, {8, "10011"}, {9, "10100"},
    {10, "00111"}, {11, "01000"}, {12, "001000"}, {13, "000011"},
    {14, "110100"}, {15, "110101"}, {16, "101010"}, {17, "101011"},
    {18, "0100111"}, {19, "0001100"}, {20, "0001000"}, {21, "0010111"},
    {22, "0000011"}, {23, "0000100"}, {24, "0101000"}, {25, "0101011"},
    {26, "0010011"}, {27, "0100100"}, {28, "0011000"}, {29, "00000010"},
    {30, "00000011"}, {31, "00011010"}, {32, "00011011"}, {33, "00010010"},
    {34, "00010011"}, {35, "00010100"}, {36, "00010101"}, {37, "00010110"},
    {38, "00010111"}, {39, "00101000"}, {40, "00101001"}, {41, "00101010"},
    {42, "00101011"}, {43, "00101100"}, {44, "00101101"}, {45, "00000100"},
    {46, "00000101"}, {47, "00001010"}, {48, "00001011"}, {49, "01010010"},
    {50, "01010011"}, {51, "01010100"}, {52, "01010101"}, {53, "00100100"},
    {54, "00100101"}, {55, "01011000"}, {56, "01011001"}, {57, "01011010"},
    {58, "01011011"}, {59, "01001010"}, {60, "01001011"}, {61, "00110010"},
    {62, "00110011"}, {63, "00110100"},
    {64, "11011"}, {128, "10010"}, {192, "010111"}, {256, "0110111"},
    {320, "00110110"}, {384, "00110111"}, {448, "01100100"},
    {512, "01100101"}, {576, "01101000"}, {640, "01100111"},
    {704, "011001100"}, {768, "011001101"}, {832, "011010010"},
    {896, "011010011"}, {960, "011010100"}, {1024, "011010101"},
    {1088, "011010110"}, {1152, "011010111"}, {1216, "011011000"},
    {1280, "011011001"}, {1344, "011011010"}, {1408, "011011011"},
    {1472, "010011000"}, {1536, "010011001"}, {1600, "010011010"},
    {1664, "011000"}, {1728, "010011011"}};

const Code kBlack[] = {
    {0, "0000110111"}, {1, "010"}, {2, "11"}, {3, "10"}, {4, "011"},
    {5, "0011"}, {6, "0010"}, {7, "00011"}, {8, "000101"}, {9, "000100"},
    {10, "0000100"}, {11, "0000101"}, {12, "0000111"}, {13, "00000100"},
    {14, "00000111"}, {15, "000011000"}, {16, "0000010111"},
    {17, "0000011000"}, {18, "0000001000"}, {19, "00001100111"},
    {20, "00001101000"}, {21, "00001101100"}, {22, "00000110111"},
    {23, "00000101000"}, {24, "00000010111"}, {25, "00000011000"},
    {26, "000011001010"}, {27, "000011001011"}, {28, "000011001100"},
    {29, "000011001101"}, {30, "000001101000"}, {31, "000001101001"},
    {32, "000001101010"}, {33, "000001101011"}, {34, "000011010010"},
    {35, "000011010011"}, {36, "000011010100"}, {37, "000011010101"},
    {38, "000011010110"}, {39, "000011010111"}, {40, "000001101100"},
    {41, "000001101101"}, {42, "000011011010"}, {43, "000011011011"},
    {44, "000001010100"}, {45, "000001010101"}, {46, "000001010110"},
    {47, "000001010111"}, {48, "000001100100"}, {49, "000001100101"},
    {50, "000001010010"}, {51, "000001010011"}, {52, "000000100100"},
    {53, "000000110111"}, {54, "000000111000"}, {55, "000000100111"},
    {56, "000000101000"}, {57, "000001011000"}, {58, "000001011001"},
    {59, "000000101011"}, {60, "000000101100"}, {61, "000001011010"},
    {62, "000001100110"}, {63, "000001100111"},
    {64, "0000001111"}, {128, "000011001000"}, {192, "000011001001"},
    {256, "000001011011"}, {320, "000000110011"}, {384, "000000110100"},
    {448, "000000110101"}, {512, "0000001101100"}, {576, "0000001101101"},
    {640, "0000001001010"}, {704, "0000001001011"}, {768, "0000001001100"},
    {832, "0000001001101"}, {896, "0000001110010"}, {960, "0000001110011"},
    {1024, "0000001110100"}, {1088, "0000001110101"},
    {1152, "0000001110110"}, {1216, "0000001110111"},
    {1280, "0000001010010"}, {1344, "0000001010011"},
    {1408, "0000001010100"}, {1472, "0000001010101"},
    {1536, "0000001011010"}, {1600, "0000001011011"},
    {1664, "0000001100100"}, {1728, "0000001100101"}};

// the extended make-up codes, shared by both colours
const Code kExtended[] = {
    {1792, "00000001000"}, {1856, "00000001100"}, {1920, "00000001101"},
    {1984, "000000010010"}, {2048, "000000010011"}, {2112, "000000010100"},
    {2176, "000000010101"}, {2240, "000000010110"}, {2304, "000000010111"},
    {2368, "000000011100"}, {2432, "000000011101"}, {2496, "000000011110"},
    {2560, "000000011111"}};

// a run by (length, code): lookup[colour][length][code], -1 where none
struct Tables {
  std::vector<int> run[2][14];
  Tables() {
    for (auto& c : run)
      for (int len = 0; len < 14; ++len) c[len].assign(1 << len, -1);
    auto put = [&](int colour, const Code& c) {
      const int len = static_cast<int>(std::strlen(c.bits));
      run[colour][len][std::stoi(c.bits, nullptr, 2)] = c.run;
    };
    for (const Code& c : kWhite) put(0, c);
    for (const Code& c : kBlack) put(1, c);
    for (const Code& c : kExtended) put(0, c), put(1, c);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

int bad(const std::string& what, long row) {
  set_error("TIFF: damaged data: CCITT " + what + " at row " +
            std::to_string(row));
  return kCorrupt;
}

struct Bits {
  const uint8_t* d;
  long n;       // bytes
  long pos = 0;  // bits read
  bool more(int k) const { return pos + k <= 8 * n; }
  int peek(int k) const {  // k bits, zeros past the end
    int v = 0;
    for (int i = 0; i < k; ++i) {
      const long b = pos + i;
      const int bit = b < 8 * n ? (d[b >> 3] >> (7 - (b & 7))) & 1 : 0;
      v = (v << 1) | bit;
    }
    return v;
  }
};

// a run of one colour: make-up codes, then a terminating code; -1 where no
// code of the tables is there (or the data ends)
long read_run(Bits* b, int colour) {
  const Tables& t = tables();
  long total = 0;
  while (true) {
    int run = -1, len = 2;
    for (; len <= 13; ++len) {
      if (!b->more(len)) return -1;
      run = t.run[colour][len][b->peek(len)];
      if (run >= 0) break;
    }
    if (run < 0) return -1;
    b->pos += len;
    total += run;
    if (run < 64) return total;
  }
}

// one 1-D row into its changes (positions where the colour flips, white
// first)
int row_1d(Bits* b, long w, long row, std::vector<long>* changes) {
  changes->clear();
  long a0 = 0;
  int colour = 0;
  while (a0 < w) {
    const long run = read_run(b, colour);
    if (run < 0) return bad("1-D code not in the tables", row);
    a0 += run;
    if (a0 > w) return bad("run past the row", row);
    if (a0 < w) changes->push_back(a0);
    colour ^= 1;
  }
  return kOk;
}

// one 2-D row against the reference row's changes
int row_2d(Bits* b, long w, long row, const std::vector<long>& ref,
           std::vector<long>* changes) {
  changes->clear();
  long a0 = -1;
  int colour = 0;
  const long nref = static_cast<long>(ref.size());
  auto b1_index = [&]() {  // the first change past a0 to the other colour
    long k = colour;         // ref[k] turns to black where k is even
    while (k < nref && ref[k] <= a0) k += 2;
    return k;
  };
  auto at = [&](long k) { return k < nref ? ref[k] : w; };
  while (a0 < w) {
    if (!b->more(1)) return bad("data ends inside a row", row);
    const long k = b1_index();
    const long b1 = at(k), b2 = at(k + 1);
    int mode;  // 0 pass, 1 horizontal, 2 vertical
    int delta = 0;
    if (b->peek(1) == 1) {
      mode = 2, b->pos += 1;
    } else if (b->peek(3) == 0b011 || b->peek(3) == 0b010) {
      mode = 2, delta = b->peek(3) == 0b011 ? 1 : -1, b->pos += 3;
    } else if (b->peek(3) == 0b001) {
      mode = 1, b->pos += 3;
    } else if (b->peek(4) == 0b0001) {
      mode = 0, b->pos += 4;
    } else if (b->peek(6) == 0b000011 || b->peek(6) == 0b000010) {
      mode = 2, delta = b->peek(6) == 0b000011 ? 2 : -2, b->pos += 6;
    } else if (b->peek(7) == 0b0000011 || b->peek(7) == 0b0000010) {
      mode = 2, delta = b->peek(7) == 0b0000011 ? 3 : -3, b->pos += 7;
    } else if (b->peek(7) == 0b0000001) {
      return bad("uncompressed mode (an extension code), which libtiff does "
                 "not decode either", row);
    } else {
      return bad("2-D code not in the tables", row);
    }
    if (mode == 0) {
      if (b2 > w) return bad("pass past the row", row);
      a0 = b2;
    } else if (mode == 1) {
      const long start = a0 < 0 ? 0 : a0;
      const long r1 = read_run(b, colour);
      const long r2 = r1 < 0 ? -1 : read_run(b, colour ^ 1);
      if (r1 < 0 || r2 < 0) return bad("1-D code not in the tables", row);
      const long a1 = start + r1, a2 = a1 + r2;
      if (a2 > w) return bad("run past the row", row);
      changes->push_back(a1);
      changes->push_back(a2);
      a0 = a2;
    } else {
      const long a1 = b1 + delta;
      if (a1 < (a0 < 0 ? 0 : a0) || a1 > w)
        return bad("vertical code past the row", row);
      changes->push_back(a1);
      a0 = a1;
      colour ^= 1;
    }
  }
  return kOk;
}

// libtiff's SYNC_EOL: on to eleven zero bits, then past the one after them
bool sync_eol(Bits* b) {
  while (true) {
    if (!b->more(11)) return false;
    if (b->peek(11) == 0) break;
    b->pos += 1;
  }
  b->pos += 11;
  while (true) {
    if (!b->more(1)) return false;
    const int bit = b->peek(1);
    b->pos += 1;
    if (bit) return true;
  }
}

}  // namespace

int ccitt_decode(const uint8_t* src, long len, int compression,
                 uint32_t t4_options, long width, long rows, uint8_t* out) {
  Bits b{src, len};
  const long row_bytes = (width + 7) / 8;
  std::vector<long> ref, cur;  // the reference row: all white
  for (long y = 0; y < rows; ++y) {
    int st;
    if (compression == 2) {
      st = row_1d(&b, width, y, &cur);
      b.pos = (b.pos + 7) & ~7L;  // each row starts on a byte
    } else if (compression == 3) {
      if (!sync_eol(&b)) return bad("data ends before an EOL", y);
      bool one_d = true;
      if (t4_options & 1) {
        if (!b.more(1)) return bad("data ends inside a row", y);
        one_d = b.peek(1) == 1;
        b.pos += 1;
      }
      st = one_d ? row_1d(&b, width, y, &cur) : row_2d(&b, width, y, ref, &cur);
    } else {
      st = row_2d(&b, width, y, ref, &cur);
    }
    if (st) return st;
    uint8_t* o = out + y * row_bytes;
    std::memset(o, 0, row_bytes);
    for (size_t k = 0; k < cur.size(); k += 2) {  // the black runs
      const long x0 = cur[k], x1 = k + 1 < cur.size() ? cur[k + 1] : width;
      for (long x = x0; x < x1; ++x) o[x >> 3] |= 0x80 >> (x & 7);
    }
    ref.swap(cur);
  }
  return kOk;
}

}  // namespace sdt
