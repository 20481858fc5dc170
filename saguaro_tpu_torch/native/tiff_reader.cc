// Native TIFF decoder for the host read path (the port's copy of
// native/tiff_reader.cc).
//
// A dependency-free reader of the screening-data subset of TIFF:
// little-endian, one sample of 8 or 16 unsigned bits, black-is-zero, in
// strips, uncompressed or LZW (predictor none or horizontal), exposed
// through a C ABI for ctypes. ctypes releases the GIL around the call, so
// host reader threads decode in parallel.
//
// sgtiff_probe says from the file's own fields whether sgtiff_decode covers
// it; the caller hands every other file to another codec. A file the probe
// accepts and the decoder then rejects is corrupt: the decoder's negative
// code says where (-7 to -10: a strip missing, out of the file, short, or a
// broken LZW stream).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 tiff_reader.cc -o libsgtiff.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  size_t len;
  bool ok = true;

  uint16_t u16(size_t off) const { return off + 2 <= len ? (uint16_t)(p[off] | p[off + 1] << 8) : 0; }
  uint32_t u32(size_t off) const {
    return off + 4 <= len ? (uint32_t)(p[off] | p[off + 1] << 8 | p[off + 2] << 16 | (uint32_t)p[off + 3] << 24) : 0;
  }
};

struct Tag {
  uint16_t id;
  uint16_t type;
  uint32_t count;
  uint32_t value_off;  // inline value or offset
};

static size_t type_size(uint16_t type) {
  switch (type) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: return 4;
    case 5: case 10: case 12: return 8;
    default: return 0;
  }
}

// read the i-th integer value of a tag
static uint32_t tag_value(const Reader& r, const Tag& t, uint32_t i, size_t tag_off) {
  size_t sz = type_size(t.type);
  size_t total = sz * t.count;
  size_t base = total <= 4 ? tag_off + 8 : t.value_off;
  size_t off = base + i * sz;
  if (sz == 2) return r.u16(off);
  if (sz == 4) return r.u32(off);
  if (sz == 1) return off < r.len ? r.p[off] : 0;
  return 0;
}

// TIFF LZW (MSB-first codes, early change) decode into out.
// Output-reference tables: every defined entry's string already exists as
// a contiguous span of decoded output (string(prev) emitted at prev_pos,
// immediately followed by first(code)), so each entry stores just
// (output offset, length) and every emit is a forward copy — no chain
// walks, no per-code allocation.
static bool lzw_decode(const uint8_t* src, size_t srclen, uint8_t* out, size_t outlen) {
  constexpr int kClear = 256, kEoi = 257, kFirstFree = 258, kMax = 4096;
  static thread_local uint32_t pos_tab[kMax];
  static thread_local uint32_t len_tab[kMax];

  int next_code = kFirstFree;
  size_t outpos = 0;
  uint64_t bitbuf = 0;
  int bits = 0;
  size_t pos = 0;
  int codesize = 9;
  int prev = -1;
  size_t prev_pos = 0;

  auto read_code = [&]() -> int {
    while (bits < codesize) {
      if (pos >= srclen) return kEoi;
      bitbuf = (bitbuf << 8) | src[pos++];
      bits += 8;
    }
    bits -= codesize;
    return (int)((bitbuf >> bits) & ((1u << codesize) - 1));
  };

  // copy n bytes from out[from] to out[outpos]; overlapping forward copy
  // must replicate byte-by-byte (KwKwK pattern repetition)
  auto emit_span = [&](size_t from, uint32_t n) {
    if (outpos + n > outlen) n = (uint32_t)(outlen - outpos);
    uint8_t* dst = out + outpos;
    const uint8_t* s = out + from;
    if (from + n <= outpos) {
      std::memcpy(dst, s, n);
    } else {
      for (uint32_t i = 0; i < n; i++) dst[i] = s[i];
    }
    outpos += n;
  };

  while (outpos < outlen) {
    int code = read_code();
    if (code == kEoi) break;
    if (code == kClear) {
      next_code = kFirstFree;
      codesize = 9;
      prev = -1;
      continue;
    }
    size_t emit_pos = outpos;
    uint32_t emit_len;
    if (code < 256) {
      if (outpos < outlen) out[outpos++] = (uint8_t)code;
      emit_len = 1;
    } else if (code >= kFirstFree && code < next_code) {
      emit_len = len_tab[code];
      emit_span(pos_tab[code], emit_len);
    } else if (code == next_code && prev >= 0 && next_code < kMax) {
      // KwKwK: entry = string(prev) + first(prev) — prev's emission
      // followed by its own first byte, contiguous at prev_pos
      emit_len = (prev < 256 ? 1u : len_tab[prev]) + 1;
      emit_span(prev_pos, emit_len);
      pos_tab[next_code] = (uint32_t)prev_pos;
      len_tab[next_code] = emit_len;
      next_code++;
      if (next_code + 1 >= (1 << codesize) && codesize < 12) codesize++;
      prev = code;
      prev_pos = emit_pos;
      continue;
    } else {
      return false;  // corrupt stream
    }
    if (prev >= 0 && next_code < kMax) {
      // new entry = string(prev) + first(code): exactly the bytes at
      // prev_pos .. prev_pos + len(prev) inclusive of code's first byte
      uint32_t plen = prev < 256 ? 1u : len_tab[prev];
      pos_tab[next_code] = (uint32_t)prev_pos;
      len_tab[next_code] = plen + 1;
      next_code++;
      // early change: bump code size one code early (TIFF spec)
      if (next_code + 1 >= (1 << codesize) && codesize < 12) codesize++;
    }
    prev = code;
    prev_pos = emit_pos;
  }
  return outpos == outlen;
}

}  // namespace

extern "C" {

// Probe the header. Returns 0 and fills (height, width, bits) when
// sgtiff_decode covers the file, 1 when it does not (big-endian, BigTIFF,
// tiles, several samples, other depths, sample formats, photometric
// interpretations, fill orders, compressions or predictors), and a negative
// code when the header cannot be read.
int sgtiff_probe(const uint8_t* data, size_t len, int* height, int* width, int* bits) {
  Reader r{data, len};
  if (len < 8) return -1;
  if (r.u16(0) != 0x4949 || r.u16(2) != 42) return 1;  // II little-endian, classic TIFF only
  uint32_t ifd = r.u32(4);
  if ((size_t)ifd + 2 > len) return -1;
  uint16_t n = r.u16(ifd);
  if ((size_t)ifd + 2 + (size_t)n * 12 > len) return -1;
  uint32_t h = 0, w = 0, bps = 1, comp = 1, spp = 1, predictor = 1, format = 1, fill = 1;
  uint32_t photometric = 0xFFFFFFFF;
  bool strips = false, counts = false, tiles = false;
  for (uint16_t i = 0; i < n; i++) {
    size_t off = ifd + 2 + (size_t)i * 12;
    Tag t{r.u16(off), r.u16(off + 2), r.u32(off + 4), r.u32(off + 8)};
    switch (t.id) {
      case 256: w = tag_value(r, t, 0, off); break;
      case 257: h = tag_value(r, t, 0, off); break;
      case 258: bps = tag_value(r, t, 0, off); break;
      case 259: comp = tag_value(r, t, 0, off); break;
      case 262: photometric = tag_value(r, t, 0, off); break;
      case 266: fill = tag_value(r, t, 0, off); break;
      case 273: strips = true; break;
      case 277: spp = tag_value(r, t, 0, off); break;
      case 279: counts = true; break;
      case 317: predictor = tag_value(r, t, 0, off); break;
      case 322: case 323: case 324: case 325: tiles = true; break;
      case 339: format = tag_value(r, t, 0, off); break;
      default: break;
    }
  }
  if (!h || !w) return -2;
  // black-is-zero must be stated: a reader takes a missing tag as
  // white-is-zero and inverts
  if (spp != 1 || (bps != 8 && bps != 16) || format != 1 || photometric != 1 || fill != 1) return 1;
  if ((comp != 1 && comp != 5) || (predictor != 1 && predictor != 2)) return 1;
  if (tiles || !strips || !counts) return 1;
  *height = (int)h;
  *width = (int)w;
  *bits = (int)bps;
  return 0;
}

// Decode into caller-allocated out (h*w elements of bits/8 bytes).
// Returns 0 on success; negative error codes otherwise.
int sgtiff_decode(const uint8_t* data, size_t len, uint8_t* out, size_t out_len) {
  Reader r{data, len};
  if (len < 8 || r.u16(0) != 0x4949 || r.u16(2) != 42) return -1;
  uint32_t ifd = r.u32(4);
  uint16_t n = r.u16(ifd);
  uint32_t h = 0, w = 0, bps = 8, comp = 1, spp = 1, rps = 0xFFFFFFFF, predictor = 1;
  std::vector<uint32_t> strip_offsets, strip_counts;
  Tag off_tag{}, cnt_tag{};
  size_t off_tag_pos = 0, cnt_tag_pos = 0;

  for (uint16_t i = 0; i < n; i++) {
    size_t off = ifd + 2 + (size_t)i * 12;
    Tag t{r.u16(off), r.u16(off + 2), r.u32(off + 4), r.u32(off + 8)};
    switch (t.id) {
      case 256: w = tag_value(r, t, 0, off); break;
      case 257: h = tag_value(r, t, 0, off); break;
      case 258: bps = tag_value(r, t, 0, off); break;
      case 259: comp = tag_value(r, t, 0, off); break;
      case 273: off_tag = t; off_tag_pos = off; break;
      case 277: spp = tag_value(r, t, 0, off); break;
      case 278: rps = tag_value(r, t, 0, off); break;
      case 279: cnt_tag = t; cnt_tag_pos = off; break;
      case 317: predictor = tag_value(r, t, 0, off); break;
      default: break;
    }
  }
  if (!h || !w) return -2;
  if (spp != 1) return -3;                      // grayscale only
  if (bps != 8 && bps != 16) return -4;
  if (comp != 1 && comp != 5) return -5;        // none or LZW
  size_t bytes_per_px = bps / 8;
  size_t need = (size_t)h * w * bytes_per_px;
  if (out_len < need) return -6;
  if (rps == 0 || rps > h) rps = h;
  uint32_t n_strips = (h + rps - 1) / rps;
  if (off_tag.count < n_strips || cnt_tag.count < n_strips) return -7;

  size_t row_bytes = (size_t)w * bytes_per_px;
  for (uint32_t s = 0; s < n_strips; s++) {
    uint32_t soff = tag_value(r, off_tag, s, off_tag_pos);
    uint32_t scnt = tag_value(r, cnt_tag, s, cnt_tag_pos);
    if ((size_t)soff + scnt > len) return -8;
    uint32_t rows = (s == n_strips - 1) ? (h - s * rps) : rps;
    size_t strip_out = (size_t)rows * row_bytes;
    uint8_t* dst = out + (size_t)s * rps * row_bytes;
    if (comp == 1) {
      if (scnt < strip_out) return -9;
      std::memcpy(dst, data + soff, strip_out);
    } else {
      if (!lzw_decode(data + soff, scnt, dst, strip_out)) return -10;
    }
    if (predictor == 2) {  // horizontal differencing
      for (uint32_t row = 0; row < rows; row++) {
        uint8_t* rp = dst + (size_t)row * row_bytes;
        if (bps == 8) {
          for (uint32_t x = 1; x < w; x++) rp[x] = (uint8_t)(rp[x] + rp[x - 1]);
        } else {
          uint16_t* rp16 = (uint16_t*)rp;
          for (uint32_t x = 1; x < w; x++) rp16[x] = (uint16_t)(rp16[x] + rp16[x - 1]);
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
