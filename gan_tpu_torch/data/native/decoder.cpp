// gan_tpu_torch native host loader: a PNG decoder over zlib, and the
// per-file work of both models' caches, on std::threads.
//
// Counterpart of gan_tpu/data/native/decoder.cpp, which decodes through
// libpng and libjpeg. This one parses PNG itself and needs only zlib (for
// inflate and crc32), so it builds wherever zlib's headers are. Its output
// equals gan_tpu's default (native) path bit for bit:
//   - every colour type (0 gray, 2 RGB, 3 palette, 4 gray+alpha, 6 RGBA),
//     bit depths 1, 2, 4, 8 and 16, the five row filters and Adam7;
//   - 16-bit samples keep their high byte (libpng's png_set_strip_16), gray
//     at 1, 2 or 4 bits is scaled by 255, 85 or 17, a palette is expanded
//     through PLTE, and alpha is dropped, not composited;
//   - then RGB -> L by PIL's integer luma, or L -> RGB by copying;
//   - Pix2Pix: split at w / 2, each half nearest-resized to `size`;
//     CycleGAN: nearest-resize to img_size, then to out_size when they
//     differ (two resizes, as the reference chains them);
//   - pix2pixHD: a label map, an instance map whose gray samples are ids
//     kept whole (16 bits as their high and low byte; below 16 bits
//     unscaled) and an RGB image, each nearest-resized to (height, width)
//     and interleaved as (label, id high, id low, R, G, B).
// A file that starts with JPEG's FF D8 is refused with its own status: the
// Python side decodes it with PIL. Every chunk's CRC is checked; ancillary
// chunks are skipped, an unknown critical one is refused.
//
// C ABI for ctypes (gan_tpu_torch/data/native/__init__.py), which builds
// this file with `g++ -O3 -std=c++17 -fPIC -shared ... -lz -lpthread` at
// first use. ctypes releases the GIL for the whole call.

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <thread>
#include <vector>

namespace {

// A file's status; gan_tpu_torch/data/native/__init__.py names each one.
enum Status : int {
  kOk = 0,
  kOpen = 1,          // cannot open or read the file
  kNotPng = 2,        // neither the PNG signature nor JPEG's FF D8
  kJpeg = 3,          // a JPEG: left to the caller
  kBadCrc = 4,        // a chunk's CRC does not match
  kTruncated = 5,     // the file or its compressed image data ends early
  kUnsupported = 6,   // a form PNG allows that this decoder does not take
  kCorrupt = 7,       // malformed chunks, zlib data or row filters
  kNoMemory = 8,
  kTooSmall = 9,      // gtt_decode's buffer is smaller than the image
};

constexpr uint32_t kMaxPixels = 1u << 30;

constexpr uint32_t chunk_type(const char* s) {
  return (uint32_t(uint8_t(s[0])) << 24) | (uint32_t(uint8_t(s[1])) << 16) |
         (uint32_t(uint8_t(s[2])) << 8) | uint32_t(uint8_t(s[3]));
}
constexpr uint32_t kIHDR = chunk_type("IHDR"), kPLTE = chunk_type("PLTE"),
                   kIDAT = chunk_type("IDAT"), kIEND = chunk_type("IEND"),
                   kTRNS = chunk_type("tRNS");

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
}

struct Header {
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0;
  int samples = 0;   // samples per pixel in the file
  int channels = 0;  // after alpha is dropped and a palette expanded: 1 or 3
  int bpp = 0;       // bytes per complete pixel, at least 1 (the filters' offset)
  size_t row_bytes(uint32_t width) const {
    return (static_cast<size_t>(width) * samples * depth + 7) / 8;
  }
};

struct Chunk {
  size_t offset, length;
};

// Adam7: x0, y0, dx, dy of each pass.
constexpr uint32_t kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                   {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

// One pass's first pixel, pixel steps and size; a plain image is one pass.
struct Pass {
  uint32_t x0, y0, dx, dy, w, h;
};

Pass pass(const Header& hd, int p) {
  if (!hd.interlace) return {0, 0, 1, 1, hd.w, hd.h};
  const uint32_t* a = kAdam7[p];
  return {a[0], a[1], a[2], a[3], hd.w > a[0] ? (hd.w - a[0] + a[2] - 1) / a[2] : 0,
          hd.h > a[1] ? (hd.h - a[1] + a[3] - 1) / a[3] : 0};
}

// One thread's buffers, reused from file to file.
struct Scratch {
  std::vector<uint8_t> file;       // the whole file
  std::vector<Chunk> idat;         // where its IDAT data lies
  std::vector<uint8_t> raw;        // inflated rows of every pass, filter bytes included
  std::vector<uint8_t> zero;       // the row above a pass's first row
  std::vector<uint8_t> image;      // (h, w, header channels), 8-bit
  std::vector<uint8_t> converted;  // (h, w, requested channels)
  std::vector<uint8_t> mid;        // CycleGAN's first resize; pix2pixHD's resized maps
  std::vector<int> rows, cols;
  uint8_t palette[256 * 3];
};

// The decoded image: 8-bit, `c` interleaved channels.
struct View {
  const uint8_t* data;
  int h, w, c;
};

int read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return kOpen;
  int status = kOk;
  long n = -1;
  if (std::fseek(f, 0, SEEK_END) == 0) n = std::ftell(f);
  if (n < 0 || std::fseek(f, 0, SEEK_SET) != 0) {
    status = kOpen;
  } else {
    buf->resize(static_cast<size_t>(n));
    if (n > 0 && std::fread(buf->data(), 1, static_cast<size_t>(n), f) != static_cast<size_t>(n))
      status = kOpen;
  }
  std::fclose(f);
  return status;
}

int parse_ihdr(const uint8_t* d, Header* hd) {
  hd->w = be32(d);
  hd->h = be32(d + 4);
  hd->depth = d[8];
  hd->color = d[9];
  hd->interlace = d[12];
  if (hd->w == 0 || hd->h == 0 || hd->w > 0x7FFFFFFFu || hd->h > 0x7FFFFFFFu) return kCorrupt;
  if (d[10] != 0 || d[11] != 0 || hd->interlace > 1) return kUnsupported;
  bool ok;
  switch (hd->color) {
    case 0: ok = hd->depth == 1 || hd->depth == 2 || hd->depth == 4 || hd->depth == 8 ||
                 hd->depth == 16;
            hd->samples = 1; hd->channels = 1; break;
    case 2: ok = hd->depth == 8 || hd->depth == 16; hd->samples = 3; hd->channels = 3; break;
    case 3: ok = hd->depth == 1 || hd->depth == 2 || hd->depth == 4 || hd->depth == 8;
            hd->samples = 1; hd->channels = 3; break;
    case 4: ok = hd->depth == 8 || hd->depth == 16; hd->samples = 2; hd->channels = 1; break;
    case 6: ok = hd->depth == 8 || hd->depth == 16; hd->samples = 4; hd->channels = 3; break;
    default: ok = false;
  }
  if (!ok) return kUnsupported;
  if (static_cast<uint64_t>(hd->w) * hd->h > kMaxPixels) return kUnsupported;
  hd->bpp = (hd->samples * hd->depth + 7) / 8;
  return kOk;
}

// Walks the chunks: header, palette and where the IDAT data lies, each
// chunk's CRC checked, up to IEND.
int parse_chunks(const std::vector<uint8_t>& f, Header* hd, Scratch* s) {
  static const uint8_t kSignature[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  const size_t n = f.size();
  if (n >= 2 && f[0] == 0xFF && f[1] == 0xD8) return kJpeg;
  if (n == 0 || std::memcmp(f.data(), kSignature, n < 8 ? n : 8) != 0) return kNotPng;
  if (n < 8) return kTruncated;
  std::memset(s->palette, 0, sizeof(s->palette));   // entries past PLTE's read as black
  s->idat.clear();
  bool have_header = false, have_palette = false, idat_ended = false;
  size_t pos = 8;
  for (;;) {
    if (n - pos < 12) return kTruncated;
    const size_t len = be32(&f[pos]);
    if (len > 0x7FFFFFFFu) return kCorrupt;
    if (n - pos - 12 < len) return kTruncated;
    const uint8_t* type = &f[pos + 4];
    const uint8_t* data = type + 4;
    const uLong crc = crc32(crc32(0L, Z_NULL, 0), type, static_cast<uInt>(len + 4));
    if (crc != be32(data + len)) return kBadCrc;
    const uint32_t t = be32(type);
    if (!have_header && t != kIHDR) return kCorrupt;
    if (t != kIDAT && !s->idat.empty()) idat_ended = true;
    if (t == kIHDR) {
      if (have_header || len != 13) return kCorrupt;
      int st = parse_ihdr(data, hd);
      if (st != kOk) return st;
      have_header = true;
    } else if (t == kPLTE) {
      if (have_palette || !s->idat.empty() || len == 0 || len % 3 != 0 || len > 768)
        return kCorrupt;
      std::memcpy(s->palette, data, len);
      have_palette = true;
    } else if (t == kIDAT) {
      if (idat_ended) return kCorrupt;   // IDAT chunks must be consecutive
      s->idat.push_back({static_cast<size_t>(data - f.data()), len});
    } else if (t == kIEND) {
      if (s->idat.empty() || (hd->color == 3 && !have_palette)) return kCorrupt;
      return kOk;
    } else if (t != kTRNS && !(type[0] & 0x20)) {
      return kUnsupported;   // an unknown critical chunk
    }
    // tRNS and ancillary chunks: alpha is dropped, so nothing to keep
    pos += 12 + len;
  }
}

// Inflates the IDAT data into exactly `need` bytes; data past them is ignored,
// as libpng ignores it.
int inflate_idat(const std::vector<uint8_t>& f, Scratch* s, size_t need) {
  if (need > 0xFFFFFFFFu) return kUnsupported;
  s->raw.resize(need);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return kNoMemory;
  zs.next_out = s->raw.data();
  zs.avail_out = static_cast<uInt>(need);
  int status = kOk;
  bool ended = false;
  for (const Chunk& c : s->idat) {
    zs.next_in = const_cast<Bytef*>(f.data() + c.offset);
    zs.avail_in = static_cast<uInt>(c.length);
    while (zs.avail_in > 0 && zs.avail_out > 0) {
      int ret = inflate(&zs, Z_NO_FLUSH);
      if (ret == Z_STREAM_END) {
        ended = true;
        break;
      }
      if (ret != Z_OK) {
        status = ret == Z_MEM_ERROR ? kNoMemory : kCorrupt;
        break;
      }
    }
    if (status != kOk || ended || zs.avail_out == 0) break;
  }
  inflateEnd(&zs);
  if (status == kOk && zs.avail_out != 0) status = kTruncated;
  return status;
}

// The Paeth predictor, without branches: on noisy rows its choice is random,
// and a branch on it mispredicts every other byte.
inline uint8_t paeth(int a, int b, int c) {
  const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  const int take_b = -(pb <= pc);                   // all ones where b beats c
  const int bc = (b & take_b) | (c & ~take_b);
  const int take_a = -((pa <= pb) & (pa <= pc));    // all ones where a beats both
  return static_cast<uint8_t>((a & take_a) | (bc & ~take_a));
}

// Undoes one row's filter in place; `prior` is the unfiltered row above.
// At one byte a pixel (8-bit gray, palettes, low-bit gray) Sub, Average and
// Paeth carry the byte to the left in a register: read back from the row,
// each byte would wait on the store of the one before it.
int unfilter(int filter, uint8_t* row, const uint8_t* prior, size_t len, int bpp) {
  switch (filter) {
    case 0:
      break;
    case 1:
      if (bpp == 1) {
        uint8_t a = 0;
        for (size_t i = 0; i < len; ++i) a = row[i] = uint8_t(row[i] + a);
        break;
      }
      for (size_t i = bpp; i < len; ++i) row[i] = uint8_t(row[i] + row[i - bpp]);
      break;
    case 2:
      for (size_t i = 0; i < len; ++i) row[i] = uint8_t(row[i] + prior[i]);
      break;
    case 3:
      if (bpp == 1) {
        int a = 0;
        for (size_t i = 0; i < len; ++i) a = row[i] = uint8_t(row[i] + ((a + prior[i]) >> 1));
        break;
      }
      for (size_t i = 0; i < static_cast<size_t>(bpp) && i < len; ++i)
        row[i] = uint8_t(row[i] + (prior[i] >> 1));
      for (size_t i = bpp; i < len; ++i)
        row[i] = uint8_t(row[i] + ((row[i - bpp] + prior[i]) >> 1));
      break;
    case 4:
      if (bpp == 1) {
        int a = 0, c = 0;   // Paeth with a = c = 0 picks b for the first byte
        for (size_t i = 0; i < len; ++i) {
          const int b = prior[i];
          a = row[i] = uint8_t(row[i] + paeth(a, b, c));
          c = b;
        }
        break;
      }
      for (size_t i = 0; i < static_cast<size_t>(bpp) && i < len; ++i)
        row[i] = uint8_t(row[i] + prior[i]);   // Paeth with a = c = 0 picks b
      for (size_t i = bpp; i < len; ++i)
        row[i] = uint8_t(row[i] + paeth(row[i - bpp], prior[i], prior[i - bpp]));
      break;
    default:
      return kCorrupt;
  }
  return kOk;
}

// One unfiltered row of `width` pixels as 8-bit samples of the header's
// channels, written every `step` pixels from `dst`.
void expand_row(const Header& hd, const uint8_t* palette, const uint8_t* src, uint32_t width,
                uint8_t* dst, int step) {
  const int c = hd.channels;
  const size_t stride = static_cast<size_t>(step) * c;
  if (hd.depth < 8) {
    const int depth = hd.depth, mask = (1 << depth) - 1;
    const int scale = depth == 1 ? 255 : depth == 2 ? 85 : 17;
    for (uint32_t i = 0; i < width; ++i) {
      const size_t bit = static_cast<size_t>(i) * depth;
      const int v = (src[bit >> 3] >> (8 - depth - (bit & 7))) & mask;
      uint8_t* d = dst + i * stride;
      if (hd.color == 0) {
        d[0] = uint8_t(v * scale);
      } else {
        std::memcpy(d, palette + 3 * v, 3);
      }
    }
    return;
  }
  if (hd.color == 3) {
    for (uint32_t i = 0; i < width; ++i) std::memcpy(dst + i * stride, palette + 3 * src[i], 3);
    return;
  }
  const size_t bytes = hd.depth / 8, pixel = hd.samples * bytes;
  if (step == 1 && pixel == static_cast<size_t>(c)) {   // 8-bit gray or RGB
    std::memcpy(dst, src, static_cast<size_t>(width) * c);
    return;
  }
  for (uint32_t i = 0; i < width; ++i) {
    const uint8_t* p = src + i * pixel;   // the high byte of each 16-bit sample
    uint8_t* d = dst + i * stride;
    d[0] = p[0];
    if (c == 3) {
      d[1] = p[bytes];
      d[2] = p[2 * bytes];
    }
  }
}

// One unfiltered row of a gray image as ids of two bytes (high, low),
// written every `step` pixels from `dst`: 16-bit samples whole, shallower
// ones unscaled in the low byte.
void expand_ids(const Header& hd, const uint8_t* src, uint32_t width, uint8_t* dst, int step) {
  const size_t stride = static_cast<size_t>(step) * 2;
  for (uint32_t i = 0; i < width; ++i) {
    uint8_t* d = dst + i * stride;
    if (hd.depth == 16) {
      d[0] = src[2 * i];
      d[1] = src[2 * i + 1];
    } else if (hd.depth == 8) {
      d[0] = 0;
      d[1] = src[i];
    } else {
      const size_t bit = static_cast<size_t>(i) * hd.depth;
      d[0] = 0;
      d[1] = uint8_t((src[bit >> 3] >> (8 - hd.depth - (bit & 7))) & ((1 << hd.depth) - 1));
    }
  }
}

// Decodes a PNG file into s->image: (h, w, hd->channels), 8-bit; with
// `ids`, a gray PNG as (h, w, 2) ids (expand_ids), and hd->channels 2.
int decode_png(const char* path, Scratch* s, Header* hd, bool ids = false) {
  int st = read_file(path, &s->file);
  if (st != kOk) return st;
  st = parse_chunks(s->file, hd, s);
  if (st != kOk) return st;
  if (ids) {
    if (hd->color != 0) return kUnsupported;
    hd->channels = 2;
  }
  const int passes = hd->interlace ? 7 : 1;
  size_t need = 0, widest = 0;
  for (int p = 0; p < passes; ++p) {
    const Pass ps = pass(*hd, p);
    if (ps.w == 0 || ps.h == 0) continue;
    const size_t rb = hd->row_bytes(ps.w);
    need += ps.h * (1 + rb);
    if (rb > widest) widest = rb;
  }
  st = inflate_idat(s->file, s, need);
  if (st != kOk) return st;
  s->zero.assign(widest, 0);
  s->image.resize(static_cast<size_t>(hd->w) * hd->h * hd->channels);
  uint8_t* row = s->raw.data();
  for (int p = 0; p < passes; ++p) {
    const Pass ps = pass(*hd, p);
    if (ps.w == 0 || ps.h == 0) continue;
    const size_t rb = hd->row_bytes(ps.w);
    const uint8_t* prior = s->zero.data();
    for (uint32_t r = 0; r < ps.h; ++r) {
      st = unfilter(row[0], row + 1, prior, rb, hd->bpp);
      if (st != kOk) return st;
      uint8_t* dst = s->image.data() +
                     ((ps.y0 + static_cast<size_t>(r) * ps.dy) * hd->w + ps.x0) * hd->channels;
      if (ids) {
        expand_ids(*hd, row + 1, ps.w, dst, static_cast<int>(ps.dx));
      } else {
        expand_row(*hd, s->palette, row + 1, ps.w, dst, static_cast<int>(ps.dx));
      }
      prior = row + 1;
      row += 1 + rb;
    }
  }
  return kOk;
}

// s->image in `channels` (1: PIL's integer luma of RGB; 3: gray copied).
View to_channels(const Header& hd, int channels, Scratch* s) {
  const int h = static_cast<int>(hd.h), w = static_cast<int>(hd.w);
  if (hd.channels == channels) return {s->image.data(), h, w, channels};
  const size_t n = static_cast<size_t>(h) * w;
  s->converted.resize(n * channels);
  const uint8_t* in = s->image.data();
  uint8_t* out = s->converted.data();
  if (channels == 1) {
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* p = in + 3 * i;
      out[i] = uint8_t((p[0] * 19595u + p[1] * 38470u + p[2] * 7471u + 0x8000u) >> 16);
    }
  } else {
    for (size_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = in[i];
  }
  return {out, h, w, channels};
}

// TF2 half-pixel nearest, as gan_tpu's ops/resize.py and decoder.cpp:
// src = min(floor((d + 0.5) * in / out), in - 1), the scale taken first.
void nearest_indices(int in_size, int out_size, std::vector<int>* idx) {
  idx->resize(out_size);
  const double scale = static_cast<double>(in_size) / out_size;
  for (int d = 0; d < out_size; ++d) {
    int i = static_cast<int>((d + 0.5) * scale);
    (*idx)[d] = i < in_size - 1 ? i : in_size - 1;
  }
}

// Resizes columns [x0, x1) of `src` into dst (out_h, out_w, src.c).
void resize_nearest(const View& src, int x0, int x1, int out_h, int out_w, Scratch* s,
                    uint8_t* dst) {
  nearest_indices(src.h, out_h, &s->rows);
  nearest_indices(x1 - x0, out_w, &s->cols);
  const int c = src.c;
  const size_t stride = static_cast<size_t>(src.w) * c;
  for (int y = 0; y < out_h; ++y) {
    const uint8_t* srow = src.data + s->rows[y] * stride + static_cast<size_t>(x0) * c;
    uint8_t* drow = dst + static_cast<size_t>(y) * out_w * c;
    if (c == 1) {
      for (int x = 0; x < out_w; ++x) drow[x] = srow[s->cols[x]];
    } else if (c == 3) {
      for (int x = 0; x < out_w; ++x) {
        const uint8_t* p = srow + static_cast<size_t>(s->cols[x]) * 3;
        drow[3 * x] = p[0];
        drow[3 * x + 1] = p[1];
        drow[3 * x + 2] = p[2];
      }
    } else {
      for (int x = 0; x < out_w; ++x)
        std::memcpy(drow + static_cast<size_t>(x) * c, srow + static_cast<size_t>(s->cols[x]) * c,
                    c);
    }
  }
}

int load_pair(const char* path, int channels, int orient_left, int size, Scratch* s,
              uint8_t* out) {
  Header hd;
  int st = decode_png(path, s, &hd);
  if (st != kOk) return st;
  const View img = to_channels(hd, channels, s);
  const int w2 = img.w / 2;   // halves [0, w2) and [w2, w), pix2pix.py:43-52
  if (w2 == 0) return kUnsupported;
  const size_t half = static_cast<size_t>(size) * size * channels;
  resize_nearest(img, orient_left ? 0 : w2, orient_left ? w2 : img.w, size, size, s, out);
  resize_nearest(img, orient_left ? w2 : 0, orient_left ? img.w : w2, size, size, s,
                 out + half);
  return kOk;
}

int load_single(const char* path, int channels, int img_size, int out_size, Scratch* s,
                uint8_t* out) {
  Header hd;
  int st = decode_png(path, s, &hd);
  if (st != kOk) return st;
  const View img = to_channels(hd, channels, s);
  if (img_size == out_size) {
    resize_nearest(img, 0, img.w, out_size, out_size, s, out);
    return kOk;
  }
  s->mid.resize(static_cast<size_t>(img_size) * img_size * channels);
  resize_nearest(img, 0, img.w, img_size, img_size, s, s->mid.data());
  const View mid{s->mid.data(), img_size, img_size, channels};
  resize_nearest(mid, 0, img_size, out_size, out_size, s, out);
  return kOk;
}

// pix2pixHD's row: (height, width, 6) = (label, id high, id low, R, G, B),
// each map nearest-resized to (height, width); a null `inst` or `img`
// leaves its channels 0. A JPEG image returns kJpeg, for the caller.
int load_hd(const char* label, const char* inst, const char* img, int height, int width,
            Scratch* s, uint8_t* out) {
  const size_t n = static_cast<size_t>(height) * width;
  std::memset(out, 0, n * 6);
  struct Part {
    const char* path;
    int channels, lo;   // channels in the row, the first of them
    bool ids;
  };
  const Part parts[3] = {{label, 1, 0, false}, {inst, 2, 1, true}, {img, 3, 3, false}};
  for (const Part& part : parts) {
    if (part.path == nullptr) continue;
    Header hd;
    int st = decode_png(part.path, s, &hd, part.ids);
    if (st != kOk) return st;
    const View img_view = part.ids ? View{s->image.data(), static_cast<int>(hd.h),
                                          static_cast<int>(hd.w), 2}
                                   : to_channels(hd, part.channels, s);
    s->mid.resize(n * part.channels);
    resize_nearest(img_view, 0, img_view.w, height, width, s, s->mid.data());
    const uint8_t* src = s->mid.data();
    for (size_t i = 0; i < n; ++i)
      for (int c = 0; c < part.channels; ++c) out[6 * i + part.lo + c] = src[i * part.channels + c];
  }
  return kOk;
}

// Runs fn(i, scratch, out row) over the files on up to n_threads threads,
// each taking the next file as it finishes one. status[i] receives file i's
// status. Returns the 1-based index of the first file that failed other
// than as a JPEG, or 0.
template <typename Fn>
int parallel_files(int n, int n_threads, size_t row_bytes, uint8_t* out, int* status, Fn fn) {
  std::atomic<int> next{0};
  auto work = [&]() {
    Scratch s;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      try {
        status[i] = fn(i, &s, out + static_cast<size_t>(i) * row_bytes);
      } catch (const std::bad_alloc&) {
        status[i] = kNoMemory;
      }
    }
  };
  if (n_threads > n) n_threads = n;
  if (n_threads <= 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  for (int i = 0; i < n; ++i)
    if (status[i] != kOk && status[i] != kJpeg) return i + 1;
  return 0;
}

}  // namespace

extern "C" {

// out: (n, 2, size, size, channels) uint8, axis 1 = (input, target).
int gtt_load_pair_batch(const char** paths, int n, int channels, int orient_left, int size,
                        uint8_t* out, int n_threads, int* status) {
  const size_t row = 2ull * size * size * channels;
  return parallel_files(n, n_threads, row, out, status, [=](int i, Scratch* s, uint8_t* dst) {
    return load_pair(paths[i], channels, orient_left, size, s, dst);
  });
}

// out: (n, out_size, out_size, channels) uint8.
int gtt_load_single_batch(const char** paths, int n, int channels, int img_size, int out_size,
                          uint8_t* out, int n_threads, int* status) {
  const size_t row = static_cast<size_t>(out_size) * out_size * channels;
  return parallel_files(n, n_threads, row, out, status, [=](int i, Scratch* s, uint8_t* dst) {
    return load_single(paths[i], channels, img_size, out_size, s, dst);
  });
}

// out: (n, height, width, 6) uint8, pix2pixHD's rows (load_hd); an entry of
// insts or imgs may be null.
int gtt_load_hd_batch(const char** labels, const char** insts, const char** imgs, int n,
                      int height, int width, uint8_t* out, int n_threads, int* status) {
  const size_t row = static_cast<size_t>(height) * width * 6;
  return parallel_files(n, n_threads, row, out, status, [=](int i, Scratch* s, uint8_t* dst) {
    return load_hd(labels[i], insts[i], imgs[i], height, width, s, dst);
  });
}

// Decodes one file into out (cap bytes) as (h, w, channels); returns its status.
int gtt_decode(const char* path, int channels, uint8_t* out, long long cap, int* h, int* w) {
  try {
    Scratch s;
    Header hd;
    int st = decode_png(path, &s, &hd);
    if (st != kOk) return st;
    const View img = to_channels(hd, channels, &s);
    *h = img.h;
    *w = img.w;
    const long long need = static_cast<long long>(img.h) * img.w * img.c;
    if (need > cap) return kTooSmall;
    std::memcpy(out, img.data, static_cast<size_t>(need));
    return kOk;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // extern "C"
