// Native length-prefixed record IO.
//
// The data plane for proto shard files ([4-byte LE length][payload] streams,
// the reference's controller_writer.py:118-147 format), implemented in C++
// for bulk throughput: one call scans a whole shard and returns record
// offsets/lengths; one call appends a batch of records with a single
// buffered write. Exposed through a C ABI for ctypes.
//
// Copy of sbsim_tpu/native/record_io.cc. Built by sbsim_tpu_torch/native/__init__.py
// (g++ -O3 -shared -fPIC) into sbsim_tpu_torch/_build/ at first use.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Scans a shard file; fills lengths[] (up to max_records) with each record's
// payload length. Returns the number of records found, or -1 on IO error,
// or -(2) on truncated trailing record.
int64_t scan_records(const char* path, int64_t* lengths,
                     int64_t max_records) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t count = 0;
  for (;;) {
    uint8_t size_bytes[4];
    size_t got = std::fread(size_bytes, 1, 4, f);
    if (got == 0) break;
    if (got < 4) {
      std::fclose(f);
      return -2;
    }
    uint32_t size = (uint32_t)size_bytes[0] | ((uint32_t)size_bytes[1] << 8) |
                    ((uint32_t)size_bytes[2] << 16) |
                    ((uint32_t)size_bytes[3] << 24);
    if (std::fseek(f, (long)size, SEEK_CUR) != 0) {
      std::fclose(f);
      return -2;
    }
    if (count < max_records) lengths[count] = size;
    ++count;
  }
  std::fclose(f);
  return count;
}

// Reads every record payload into `buffer` (concatenated); caller sizes the
// buffer from scan_records. Returns total bytes written or -1 on error.
int64_t read_all_records(const char* path, uint8_t* buffer,
                         int64_t buffer_size) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t offset = 0;
  for (;;) {
    uint8_t size_bytes[4];
    size_t got = std::fread(size_bytes, 1, 4, f);
    if (got == 0) break;
    if (got < 4) {
      std::fclose(f);
      return -1;
    }
    uint32_t size = (uint32_t)size_bytes[0] | ((uint32_t)size_bytes[1] << 8) |
                    ((uint32_t)size_bytes[2] << 16) |
                    ((uint32_t)size_bytes[3] << 24);
    if (offset + (int64_t)size > buffer_size) {
      std::fclose(f);
      return -1;
    }
    if (std::fread(buffer + offset, 1, size, f) != size) {
      std::fclose(f);
      return -1;
    }
    offset += size;
  }
  std::fclose(f);
  return offset;
}

// Appends `n` records whose payloads are concatenated in `data` with
// per-record lengths in `lengths`. Returns 0 on success.
int32_t append_records(const char* path, const uint8_t* data,
                       const int64_t* lengths, int64_t n) {
  FILE* f = std::fopen(path, "ab");
  if (!f) return -1;
  std::vector<uint8_t> buf;
  int64_t offset = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t size = (uint32_t)lengths[i];
    uint8_t size_bytes[4] = {
        (uint8_t)(size & 0xff), (uint8_t)((size >> 8) & 0xff),
        (uint8_t)((size >> 16) & 0xff), (uint8_t)((size >> 24) & 0xff)};
    buf.insert(buf.end(), size_bytes, size_bytes + 4);
    buf.insert(buf.end(), data + offset, data + offset + size);
    offset += size;
  }
  const int ok =
      std::fwrite(buf.data(), 1, buf.size(), f) == buf.size() ? 0 : -1;
  std::fclose(f);
  return ok;
}

}  // extern "C"
