// Chunked record file format — the native IO core of the input pipeline
// (the port's copy of paddle_tpu/native/recordio.cc: the same layout, so
// either package reads the other's files).
//
// Role model: Paddle's paddle/fluid/recordio/ (header.h:39 Header
// {NumRecords, Checksum, Compressor, CompressSize}, chunk.h:26 Chunk,
// writer.h / scanner.h), with its own layout:
//
//   file   := MAGIC8 chunk*
//   chunk  := u32 magic | u32 num_records | u32 compressor | u64 raw_len
//             | u64 payload_len | u32 crc32(payload) | payload
//   payload(raw)      := (u32 len | bytes)*
//   payload(deflate)  := zlib-compressed payload(raw)
//
// All integers little-endian. CRC is zlib crc32 over the stored (possibly
// compressed) payload, verified by the scanner before decompression — the
// reference's WrongChecksum contract. Exposed through a C ABI consumed by
// ctypes (paddle_tpu_torch/recordio/__init__.py), which also carries a pure-Python
// fallback writing the identical format.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr char kFileMagic[8] = {'P', 'T', 'R', 'C', '0', '0', '0', '1'};
constexpr uint32_t kChunkMagic = 0x43485054u;  // "TPHC"

enum Compressor : uint32_t { kRaw = 0, kDeflate = 1 };

struct Writer {
  FILE* f = nullptr;
  uint32_t compressor = kRaw;
  uint32_t max_records = 1000;
  uint64_t max_bytes = 1u << 20;
  std::string buf;
  uint32_t n_records = 0;
  int error = 0;

  void flush_chunk() {
    if (n_records == 0) return;
    std::string payload;
    const std::string* out = &buf;
    if (compressor == kDeflate) {
      uLongf cap = compressBound(buf.size());
      payload.resize(cap);
      if (compress2(reinterpret_cast<Bytef*>(&payload[0]), &cap,
                    reinterpret_cast<const Bytef*>(buf.data()), buf.size(),
                    Z_DEFAULT_COMPRESSION) != Z_OK) {
        error = 1;
        return;
      }
      payload.resize(cap);
      out = &payload;
    }
    uint32_t crc = crc32(0L, reinterpret_cast<const Bytef*>(out->data()),
                         out->size());
    uint64_t raw_len = buf.size(), pay_len = out->size();
    if (fwrite(&kChunkMagic, 4, 1, f) != 1 ||
        fwrite(&n_records, 4, 1, f) != 1 ||
        fwrite(&compressor, 4, 1, f) != 1 ||
        fwrite(&raw_len, 8, 1, f) != 1 || fwrite(&pay_len, 8, 1, f) != 1 ||
        fwrite(&crc, 4, 1, f) != 1 ||
        (pay_len && fwrite(out->data(), pay_len, 1, f) != 1)) {
      error = 1;
    }
    buf.clear();
    n_records = 0;
  }
};

struct Scanner {
  FILE* f = nullptr;
  std::string chunk;       // decompressed current chunk payload
  size_t pos = 0;          // cursor within chunk
  uint32_t remaining = 0;  // records left in current chunk
  int error = 0;

  bool load_chunk() {
    uint32_t magic, n, comp, crc;
    uint64_t raw_len, pay_len;
    if (fread(&magic, 4, 1, f) != 1) return false;  // clean EOF
    if (magic != kChunkMagic || fread(&n, 4, 1, f) != 1 ||
        fread(&comp, 4, 1, f) != 1 || fread(&raw_len, 8, 1, f) != 1 ||
        fread(&pay_len, 8, 1, f) != 1 || fread(&crc, 4, 1, f) != 1) {
      error = 1;
      return false;
    }
    std::string payload(pay_len, '\0');
    if (pay_len && fread(&payload[0], pay_len, 1, f) != 1) {
      error = 1;
      return false;
    }
    if (crc32(0L, reinterpret_cast<const Bytef*>(payload.data()),
              payload.size()) != crc) {
      error = 2;  // WrongChecksum
      return false;
    }
    if (comp == kDeflate) {
      chunk.assign(raw_len, '\0');
      uLongf dlen = raw_len;
      if (uncompress(reinterpret_cast<Bytef*>(&chunk[0]), &dlen,
                     reinterpret_cast<const Bytef*>(payload.data()),
                     payload.size()) != Z_OK ||
          dlen != raw_len) {
        error = 1;
        return false;
      }
    } else {
      chunk.swap(payload);
    }
    pos = 0;
    remaining = n;
    return true;
  }
};

}  // namespace

extern "C" {

void* ptrc_writer_open(const char* path, int compressor, int max_records,
                       uint64_t max_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  if (fwrite(kFileMagic, 8, 1, f) != 1) {
    fclose(f);
    return nullptr;
  }
  Writer* w = new Writer();
  w->f = f;
  w->compressor = static_cast<uint32_t>(compressor);
  w->max_records = max_records > 0 ? max_records : 1000;
  w->max_bytes = max_bytes > 0 ? max_bytes : (1u << 20);
  return w;
}

int ptrc_writer_write(void* vw, const char* data, uint64_t len) {
  Writer* w = static_cast<Writer*>(vw);
  uint32_t l = static_cast<uint32_t>(len);
  w->buf.append(reinterpret_cast<const char*>(&l), 4);
  w->buf.append(data, len);
  w->n_records++;
  if (w->n_records >= w->max_records || w->buf.size() >= w->max_bytes)
    w->flush_chunk();
  return w->error;
}

int ptrc_writer_close(void* vw) {
  Writer* w = static_cast<Writer*>(vw);
  w->flush_chunk();
  int err = w->error;
  if (w->f) fclose(w->f);
  delete w;
  return err;
}

void* ptrc_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  char magic[8];
  if (fread(magic, 8, 1, f) != 1 || memcmp(magic, kFileMagic, 8) != 0) {
    fclose(f);
    return nullptr;
  }
  Scanner* s = new Scanner();
  s->f = f;
  return s;
}

// Returns record length and sets *out to a pointer valid until the next
// call; -1 on EOF, -2 on corruption, -3 on checksum mismatch.
int64_t ptrc_scanner_next(void* vs, const char** out) {
  Scanner* s = static_cast<Scanner*>(vs);
  if (s->remaining == 0) {
    if (!s->load_chunk())
      return s->error == 0 ? -1 : (s->error == 2 ? -3 : -2);
  }
  if (s->pos + 4 > s->chunk.size()) return -2;
  uint32_t len;
  memcpy(&len, s->chunk.data() + s->pos, 4);
  s->pos += 4;
  if (s->pos + len > s->chunk.size()) return -2;
  *out = s->chunk.data() + s->pos;
  s->pos += len;
  s->remaining--;
  return static_cast<int64_t>(len);
}

void ptrc_scanner_close(void* vs) {
  Scanner* s = static_cast<Scanner*>(vs);
  if (s->f) fclose(s->f);
  delete s;
}

}  // extern "C"
