// statecodec — native batched-state checkpoint codec.
//
// The reference has no trajectory checkpointing (SURVEY.md §5); its nearest
// mechanisms are reset/keyframes. For a batched TPU server, snapshotting
// thousands of env states is a first-class, latency-sensitive host-side op:
// this codec packs/unpacks a set of arrays into one contiguous blob with a
// CRC32-guarded header, using multi-threaded memcpy for multi-hundred-MB
// batched states. Exposed over a C ABI (ctypes; no pybind11 dependency).
//
// Blob layout:
//   [magic u32 = 0x4D545055 'MTPU'][version u32][crc32 u32][narr u32]
//   then per array: [nbytes u64][data ...]
// (Shapes/dtypes live in the Python-side JSON header next to the blob.)

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x4D545055u;
constexpr uint32_t kVersion = 1;

uint32_t crc32_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc32_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32(const uint8_t* data, size_t len, uint32_t seed) {
  crc_init();
  uint32_t c = seed ^ 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++)
    c = crc32_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

void parallel_copy(uint8_t* dst, const uint8_t* src, size_t n) {
  const size_t kPar = 4, kMin = 8u << 20;  // parallelize >8MB copies
  if (n < kMin) {
    std::memcpy(dst, src, n);
    return;
  }
  std::vector<std::thread> ts;
  size_t chunk = (n + kPar - 1) / kPar;
  for (size_t i = 0; i < kPar; i++) {
    size_t off = i * chunk;
    if (off >= n) break;
    size_t len = (off + chunk > n) ? n - off : chunk;
    ts.emplace_back([=] { std::memcpy(dst + off, src + off, len); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// total blob size for arrays of the given byte sizes
uint64_t codec_blob_size(const uint64_t* sizes, uint32_t narr) {
  uint64_t total = 16;  // header
  for (uint32_t i = 0; i < narr; i++) total += 8 + sizes[i];
  return total;
}

// pack arrays (pointers+sizes) into out; returns bytes written, 0 on error
uint64_t codec_pack(const uint8_t** bufs, const uint64_t* sizes,
                    uint32_t narr, uint8_t* out, uint64_t cap) {
  uint64_t need = codec_blob_size(sizes, narr);
  if (cap < need) return 0;
  uint8_t* p = out + 16;
  uint32_t crc = 0;
  for (uint32_t i = 0; i < narr; i++) {
    std::memcpy(p, &sizes[i], 8);
    p += 8;
    parallel_copy(p, bufs[i], sizes[i]);
    crc = crc32(p, sizes[i], crc);
    p += sizes[i];
  }
  std::memcpy(out, &kMagic, 4);
  std::memcpy(out + 4, &kVersion, 4);
  std::memcpy(out + 8, &crc, 4);
  std::memcpy(out + 12, &narr, 4);
  return need;
}

// unpack blob into pre-allocated buffers; returns narr, or 0 on failure
// (bad magic/version/crc/size mismatch)
uint32_t codec_unpack(const uint8_t* blob, uint64_t blob_len,
                      uint8_t** bufs, const uint64_t* sizes, uint32_t narr) {
  if (blob_len < 16) return 0;
  uint32_t magic, version, crc_stored, n;
  std::memcpy(&magic, blob, 4);
  std::memcpy(&version, blob + 4, 4);
  std::memcpy(&crc_stored, blob + 8, 4);
  std::memcpy(&n, blob + 12, 4);
  if (magic != kMagic || version != kVersion || n != narr) return 0;
  const uint8_t* p = blob + 16;
  uint32_t crc = 0;
  for (uint32_t i = 0; i < narr; i++) {
    if (static_cast<uint64_t>(p - blob) + 8 > blob_len) return 0;
    uint64_t nbytes;
    std::memcpy(&nbytes, p, 8);
    p += 8;
    if (nbytes != sizes[i]) return 0;
    if (static_cast<uint64_t>(p - blob) + nbytes > blob_len) return 0;
    parallel_copy(bufs[i], p, nbytes);
    crc = crc32(p, nbytes, crc);
    p += nbytes;
  }
  return (crc == crc_stored) ? narr : 0;
}

}  // extern "C"
