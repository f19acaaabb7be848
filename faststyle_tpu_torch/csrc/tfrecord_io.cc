// TFRecord codec hot paths on the host: masked CRC32C and record-frame
// scanning (the port's own copy of faststyle_tpu/native/tfrecord_io.cc).
//
// Built by faststyle_tpu_torch/ops/cuda/build.py with the host C++ compiler
// and called through ctypes (which releases the GIL, so writer and reader
// threads run it concurrently).
//
// TFRecord framing:
//   uint64 length | uint32 masked_crc32c(length) | bytes data |
//   uint32 masked_crc32c(data)
// masked_crc = ((crc >> 15) | (crc << 17)) + 0xa282ead8

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

uint32_t kTable[8][256];
std::once_flag table_once;

void init_tables() {
  // CRC32C (Castagnoli) polynomial, reflected: 0x82F63B78, slice-by-8.
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j)
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    kTable[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int k = 1; k < 8; ++k)
      kTable[k][i] = (kTable[k - 1][i] >> 8) ^ kTable[0][kTable[k - 1][i] & 0xFF];
}

uint32_t crc32c(const uint8_t* data, size_t n) {
  // callers run on concurrent Python threads (the writer pool)
  std::call_once(table_once, init_tables);
  uint32_t crc = 0xFFFFFFFFu;
  // slice-by-8 main loop
  while (n >= 8) {
    uint32_t lo;
    uint32_t hi;
    std::memcpy(&lo, data, 4);
    std::memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = kTable[7][lo & 0xFF] ^ kTable[6][(lo >> 8) & 0xFF] ^
          kTable[5][(lo >> 16) & 0xFF] ^ kTable[4][lo >> 24] ^
          kTable[3][hi & 0xFF] ^ kTable[2][(hi >> 8) & 0xFF] ^
          kTable[1][(hi >> 16) & 0xFF] ^ kTable[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kTable[0][(crc ^ *data++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

inline uint32_t mask(uint32_t crc) {
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

}  // namespace

extern "C" {

uint32_t fs_masked_crc32c(const uint8_t* data, size_t n) {
  return mask(crc32c(data, n));
}

// Scan a buffer of concatenated TFRecords; fill (offset, length) pairs for up
// to max_records records. Returns the number found, or -1 on corruption
// (bad length-crc, or bad data-crc when verify != 0). A truncated final
// record ends the scan without an error.
long fs_scan_records(const uint8_t* buf, size_t n, long* offsets,
                     long* lengths, long max_records, int verify) {
  size_t pos = 0;
  long count = 0;
  while (pos + 16 <= n && count < max_records) {
    uint64_t len;
    std::memcpy(&len, buf + pos, 8);
    uint32_t len_crc;
    std::memcpy(&len_crc, buf + pos + 8, 4);
    if (mask(crc32c(buf + pos, 8)) != len_crc) return -1;
    // subtraction form: `pos + 12 + len + 4 > n` can wrap for a corrupt
    // near-2^64 length (the length CRC only proves the 8 bytes are
    // self-consistent, not sane); pos + 16 <= n holds per the loop condition
    if (len > n - pos - 16) break;  // truncated tail
    if (verify) {
      uint32_t data_crc;
      std::memcpy(&data_crc, buf + pos + 12 + len, 4);
      if (mask(crc32c(buf + pos + 12, len)) != data_crc) return -1;
    }
    offsets[count] = static_cast<long>(pos + 12);
    lengths[count] = static_cast<long>(len);
    ++count;
    pos += 12 + len + 4;
  }
  return count;
}

// Frame a record into out (the caller allocates len + 16 bytes).
void fs_frame_record(const uint8_t* data, size_t len, uint8_t* out) {
  uint64_t len64 = len;
  std::memcpy(out, &len64, 8);
  uint32_t len_crc = mask(crc32c(out, 8));
  std::memcpy(out + 8, &len_crc, 4);
  std::memcpy(out + 12, data, len);
  uint32_t data_crc = mask(crc32c(data, len));
  std::memcpy(out + 12 + len, &data_crc, 4);
}

}  // extern "C"
