// Native CRAM codecs: rANS 4x8 decode (CRAM 3.0 spec sec 13, the codec
// htslib uses for the default samtools profile's byte streams).
//
// The Python reference implementation (io/cramio.py rans_decode) is kept as
// the oracle; this decoder replicates it bit-for-bit — including the
// byte-starvation renormalisation guard (renorm stops at end of input) and
// the order-1 state-3 remainder loop — at native speed, because the BA/QS
// payloads of a real CRAM put the whole base/qual volume through this path
// (a per-byte Python loop costs ~1 us/byte; this runs at memory speed).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t RANS_L = 1u << 23;
constexpr int TOTFREQ = 4096;

// Order-0 frequency table (spec 13.6): ascending-symbol RLE, 7/15-bit freqs.
// Returns new offset or -1 on truncation/corruption.
static int64_t read_freqs0(const uint8_t *buf, int64_t p, int64_t len,
                           int32_t f[256]) {
  std::memset(f, 0, 256 * sizeof(int32_t));
  if (p >= len) return -1;
  int rle = 0;
  int j = buf[p++];
  for (;;) {
    if (p >= len) return -1;
    int32_t fv = buf[p++];
    if (fv & 0x80) {
      if (p >= len) return -1;
      fv = ((fv & 0x7F) << 8) | buf[p++];
    }
    if (j < 0 || j > 255) return -1;
    f[j] = fv;
    if (rle) {
      rle--;
      j++;
    } else if (p < len && buf[p] == j + 1) {
      j = buf[p++];
      if (p >= len) return -1;
      rle = buf[p++];
    } else {
      if (p >= len) return -1;
      j = buf[p++];
      if (j == 0) break;
    }
  }
  return p;
}

struct Table {
  int32_t f[256];
  int32_t cum[256];
  uint8_t sym[TOTFREQ];
  // build cum + 12-bit symbol lookup; false if freqs do not sum to 4096
  bool build() {
    int32_t c = 0;
    for (int s = 0; s < 256; s++) {
      cum[s] = c;
      for (int32_t i = 0; i < f[s]; i++) {
        if (c + i >= TOTFREQ) return false;
        sym[c + i] = (uint8_t)s;
      }
      c += f[s];
    }
    return c == TOTFREQ;
  }
};

static inline void renorm(uint32_t &x, const uint8_t *buf, int64_t &p,
                          int64_t m) {
  while (x < RANS_L && p < m) x = (x << 8) | buf[p++];
}

}  // namespace

extern "C" {

// Decode one rANS 4x8 stream (header included: order u8, csize u32,
// rsize u32).  out must hold out_len == rsize bytes.  Returns bytes
// written (== out_len) or a negative error:
//   -1 truncated/corrupt input, -2 bad frequency table,
//   -3 unsupported order, -4 size mismatch.
int64_t cram_rans_decode(const uint8_t *comp, int64_t clen, uint8_t *out,
                         int64_t out_len) {
  if (clen < 9) return -1;
  const int order = comp[0];
  uint32_t rsize;
  std::memcpy(&rsize, comp + 5, 4);  // little-endian host assumed (x86/arm)
  if ((int64_t)rsize != out_len) return -4;
  int64_t p = 9;
  const int64_t n = out_len;
  if (n == 0) return 0;
  const int64_t m = clen;

  if (order == 0) {
    std::vector<Table> tab(1);
    p = read_freqs0(comp, p, m, tab[0].f);
    if (p < 0) return -1;
    if (!tab[0].build()) return -2;
    if (p + 16 > m) return -1;
    uint32_t st[4];
    std::memcpy(st, comp + p, 16);
    p += 16;
    const Table &t = tab[0];
    for (int64_t i = 0; i < n; i++) {
      uint32_t &x = st[i & 3];
      const uint32_t mm = x & 0xFFF;
      const uint8_t s = t.sym[mm];
      out[i] = s;
      x = (uint32_t)t.f[s] * (x >> 12) + mm - (uint32_t)t.cum[s];
      renorm(x, comp, p, m);
    }
    return n;
  }
  if (order != 1) return -3;

  // order-1: per-context tables, same RLE on the context list
  std::vector<Table> tab(256);
  std::vector<uint8_t> present(256, 0);
  {
    int rle = 0;
    if (p >= m) return -1;
    int c = comp[p++];
    for (;;) {
      if (c < 0 || c > 255) return -1;
      p = read_freqs0(comp, p, m, tab[c].f);
      if (p < 0) return -1;
      if (!tab[c].build()) return -2;
      present[c] = 1;
      if (rle) {
        rle--;
        c++;
      } else if (p < m && comp[p] == c + 1) {
        c = comp[p++];
        if (p >= m) return -1;
        rle = comp[p++];
      } else {
        if (p >= m) return -1;
        c = comp[p++];
        if (c == 0) break;
      }
    }
  }
  if (p + 16 > m) return -1;
  uint32_t st[4];
  std::memcpy(st, comp + p, 16);
  p += 16;
  const int64_t isz4 = n >> 2;
  int64_t ptrs[4] = {0, isz4, 2 * isz4, 3 * isz4};
  int ctxs[4] = {0, 0, 0, 0};
  for (int64_t r = 0; r < isz4; r++) {
    for (int j = 0; j < 4; j++) {
      uint32_t &x = st[j];
      const int c = ctxs[j];
      if (!present[c]) return -2;
      const Table &t = tab[c];
      const uint32_t mm = x & 0xFFF;
      const uint8_t s = t.sym[mm];
      out[ptrs[j]++] = s;
      x = (uint32_t)t.f[s] * (x >> 12) + mm - (uint32_t)t.cum[s];
      renorm(x, comp, p, m);
      ctxs[j] = s;
    }
  }
  {
    uint32_t x = st[3];
    int c = ctxs[3];
    for (int64_t i = 4 * isz4; i < n; i++) {
      if (!present[c]) return -2;
      const Table &t = tab[c];
      const uint32_t mm = x & 0xFFF;
      const uint8_t s = t.sym[mm];
      out[i] = s;
      x = (uint32_t)t.f[s] * (x >> 12) + mm - (uint32_t)t.cum[s];
      renorm(x, comp, p, m);
      c = s;
    }
  }
  return n;
}

}  // extern "C"
