// CRC-32C (Castagnoli) over a byte buffer, slice-by-8: the checksum that
// TFRecord frames and TF checkpoint bundles carry (models/bert_ckpt.py
// checks every tensor it reads, ~420 MB for BERT-base), about 1.6 GB/s on
// one core where the table-driven Python loop of data/tfrecord.py runs a
// few MB/s.

#include <cstdint>
#include <cstring>

namespace {

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t n = 0; n < 256; ++n) {
      uint32_t c = n;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][n] = c;
    }
    for (uint32_t n = 0; n < 256; ++n)
      for (int s = 1; s < 8; ++s)
        t[s][n] = (t[s - 1][n] >> 8) ^ t[0][t[s - 1][n] & 0xFF];
  }
};

const Tables& tables() {
  static const Tables instance;
  return instance;
}

}  // namespace

extern "C" uint32_t rt_crc32c(const uint8_t* data, int64_t n, uint32_t crc) {
  const auto& t = tables().t;
  crc = ~crc;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data, 4);
    std::memcpy(&hi, data + 4, 4);
    lo ^= crc;  // little-endian hosts: the byte order of the buffer
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
          t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
          t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n-- > 0) crc = t[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}
