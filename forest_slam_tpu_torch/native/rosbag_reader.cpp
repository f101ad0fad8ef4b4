// Native ROS1 bag (format 2.0) image reader: the port's copy of
// forest_slam_tpu/native/rosbag_reader.cpp.
//
// One pass over the file parses the record grammar
// (<u32 hlen><fields: u32 len, name=value><u32 dlen><data>), inflates bz2
// chunks, indexes the sensor_msgs/Image messages of each topic, and copies
// frames straight into a caller-provided NumPy buffer (no per-message
// Python objects). Plain and bz2 chunks only: a bag with lz4 chunks fails
// to open here and is read by the Python parser (io/rosbag.py). Exposed
// through a C ABI loaded with ctypes (forest_slam_tpu_torch/native/
// __init__.py builds it with g++ into forest_slam_tpu_torch/_build/).
//
// libbz2's development header need not be installed, so the one entry
// point used is declared here and resolved from libbz2.so.1 at link time.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <map>
#include <memory>
#include <string>
#include <vector>

extern "C" int BZ2_bzBuffToBuffDecompress(char* dest, unsigned* destLen,
                                          char* source, unsigned sourceLen,
                                          int small, int verbosity);

namespace {

constexpr uint8_t OP_CHUNK = 0x05;
constexpr uint8_t OP_CONNECTION = 0x07;
constexpr uint8_t OP_MSG_DATA = 0x02;

struct Header {
  std::map<std::string, std::string> fields;
  const std::string* get(const char* k) const {
    auto it = fields.find(k);
    return it == fields.end() ? nullptr : &it->second;
  }
};

bool read_u32(const uint8_t* buf, size_t len, size_t& off, uint32_t& out) {
  if (off + 4 > len) return false;
  std::memcpy(&out, buf + off, 4);
  off += 4;
  return true;
}

bool parse_header(const uint8_t* buf, size_t hlen, Header& h) {
  size_t off = 0;
  while (off < hlen) {
    uint32_t flen;
    if (!read_u32(buf, hlen, off, flen) || off + flen > hlen) return false;
    const char* field = reinterpret_cast<const char*>(buf + off);
    const char* eq = static_cast<const char*>(std::memchr(field, '=', flen));
    if (!eq) return false;
    h.fields.emplace(std::string(field, eq - field),
                     std::string(eq + 1, field + flen - (eq + 1)));
    off += flen;
  }
  return true;
}

struct ImageRef {
  // view into the (decompressed) chunk storage
  const uint8_t* data;
  size_t len;
  double time;
};

struct Bag {
  std::vector<std::unique_ptr<std::vector<uint8_t>>> storage;
  std::map<uint32_t, std::string> conn_topic;  // conn id -> topic
  std::map<std::string, std::vector<ImageRef>> by_topic;
  std::string error;
};

// scan one records stream (file body or decompressed chunk payload)
bool scan_records(Bag& bag, const uint8_t* buf, size_t len, bool top_level);

bool handle_chunk(Bag& bag, const Header& h, const uint8_t* data, size_t dlen) {
  const std::string* comp = h.get("compression");
  if (!comp || *comp == "none") {
    return scan_records(bag, data, dlen, false);
  }
  if (*comp == "bz2") {
    const std::string* size = h.get("size");
    if (!size || size->size() != 4) return false;
    uint32_t raw_size;
    std::memcpy(&raw_size, size->data(), 4);
    auto out = std::make_unique<std::vector<uint8_t>>(raw_size);
    unsigned dest_len = raw_size;
    int rc = BZ2_bzBuffToBuffDecompress(
        reinterpret_cast<char*>(out->data()), &dest_len,
        const_cast<char*>(reinterpret_cast<const char*>(data)),
        static_cast<unsigned>(dlen), 0, 0);
    if (rc != 0) {
      bag.error = "bz2 decompress failed rc=" + std::to_string(rc);
      return false;
    }
    const uint8_t* p = out->data();
    bag.storage.push_back(std::move(out));
    return scan_records(bag, p, dest_len, false);
  }
  bag.error = "unsupported chunk compression: " + *comp;
  return false;
}

bool scan_records(Bag& bag, const uint8_t* buf, size_t len, bool top_level) {
  size_t off = 0;
  while (off < len) {
    uint32_t hlen;
    if (!read_u32(buf, len, off, hlen)) break;
    if (off + hlen > len) return false;
    Header h;
    if (!parse_header(buf + off, hlen, h)) return false;
    off += hlen;
    uint32_t dlen;
    if (!read_u32(buf, len, off, dlen) || off + dlen > len) return false;
    const uint8_t* data = buf + off;
    off += dlen;

    const std::string* op_s = h.get("op");
    if (!op_s || op_s->empty()) continue;
    uint8_t op = static_cast<uint8_t>((*op_s)[0]);
    if (op == OP_CONNECTION) {
      const std::string* conn = h.get("conn");
      const std::string* topic = h.get("topic");
      if (conn && conn->size() == 4 && topic) {
        uint32_t id;
        std::memcpy(&id, conn->data(), 4);
        bag.conn_topic[id] = *topic;
      }
    } else if (op == OP_MSG_DATA) {
      const std::string* conn = h.get("conn");
      const std::string* time = h.get("time");
      if (!conn || conn->size() != 4) continue;
      uint32_t id;
      std::memcpy(&id, conn->data(), 4);
      auto it = bag.conn_topic.find(id);
      if (it == bag.conn_topic.end()) continue;
      double t = 0.0;
      if (time && time->size() == 8) {
        uint32_t sec, nsec;
        std::memcpy(&sec, time->data(), 4);
        std::memcpy(&nsec, time->data() + 4, 4);
        t = sec + nsec * 1e-9;
      }
      bag.by_topic[it->second].push_back(ImageRef{data, dlen, t});
    } else if (op == OP_CHUNK && top_level) {
      if (!handle_chunk(bag, h, data, dlen)) return false;
    }
  }
  return true;
}

// sensor_msgs/Image layout: Header{seq u32, stamp u32+u32, frame_id str},
// height u32, width u32, encoding str, is_bigendian u8, step u32,
// data (u32 len + bytes)
struct ImageView {
  double stamp;
  uint32_t height, width, step;
  std::string encoding;
  const uint8_t* pixels;
  uint32_t pixel_len;
};

bool parse_image(const ImageRef& ref, ImageView& out) {
  const uint8_t* b = ref.data;
  size_t len = ref.len, off = 0;
  uint32_t seq, sec, nsec, frame_len;
  if (!read_u32(b, len, off, seq)) return false;
  if (!read_u32(b, len, off, sec)) return false;
  if (!read_u32(b, len, off, nsec)) return false;
  if (!read_u32(b, len, off, frame_len) || off + frame_len > len) return false;
  off += frame_len;
  out.stamp = sec + nsec * 1e-9;
  if (!read_u32(b, len, off, out.height)) return false;
  if (!read_u32(b, len, off, out.width)) return false;
  uint32_t enc_len;
  if (!read_u32(b, len, off, enc_len) || off + enc_len > len) return false;
  out.encoding.assign(reinterpret_cast<const char*>(b + off), enc_len);
  off += enc_len;
  if (off + 1 > len) return false;
  off += 1;  // is_bigendian
  if (!read_u32(b, len, off, out.step)) return false;
  if (!read_u32(b, len, off, out.pixel_len) || off + out.pixel_len > len)
    return false;
  out.pixels = b + off;
  return true;
}

}  // namespace

extern "C" {

void* fsbag_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  auto file = std::make_unique<std::vector<uint8_t>>(size);
  if (std::fread(file->data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  static const char MAGIC[] = "#ROSBAG V2.0\n";
  size_t mlen = sizeof(MAGIC) - 1;
  if (static_cast<size_t>(size) < mlen ||
      std::memcmp(file->data(), MAGIC, mlen) != 0)
    return nullptr;

  auto bag = new Bag();
  const uint8_t* p = file->data();
  bag->storage.push_back(std::move(file));
  if (!scan_records(*bag, p + mlen, size - mlen, true)) {
    delete bag;
    return nullptr;
  }
  return bag;
}

void fsbag_close(void* h) { delete static_cast<Bag*>(h); }

long fsbag_count(void* h, const char* topic) {
  auto& bag = *static_cast<Bag*>(h);
  auto it = bag.by_topic.find(topic);
  return it == bag.by_topic.end() ? 0 : static_cast<long>(it->second.size());
}

// Fills H/W/channels/encoding (buffer >= 32 bytes) from the first message.
int fsbag_image_info(void* h, const char* topic, int* H, int* W,
                     int* channels, char* encoding_out) {
  auto& bag = *static_cast<Bag*>(h);
  auto it = bag.by_topic.find(topic);
  if (it == bag.by_topic.end() || it->second.empty()) return -1;
  ImageView v;
  if (!parse_image(it->second[0], v)) return -2;
  *H = static_cast<int>(v.height);
  *W = static_cast<int>(v.width);
  *channels = v.width ? static_cast<int>(v.step / v.width) : 0;
  std::snprintf(encoding_out, 32, "%s", v.encoding.c_str());
  return 0;
}

// Copies up to max_frames images (every `stride`-th message) into `out`
// (shape [max_frames, H, W, channels] uint8, C-contiguous) and their
// stamps into `stamps`. Returns the number of frames written, or a
// negative error code.
long fsbag_read_images(void* h, const char* topic, unsigned char* out,
                       long max_frames, long stride, double* stamps) {
  auto& bag = *static_cast<Bag*>(h);
  auto it = bag.by_topic.find(topic);
  if (it == bag.by_topic.end()) return -1;
  if (stride < 1) stride = 1;
  long written = 0;
  size_t frame_bytes = 0;
  uint32_t H0 = 0, W0 = 0, step0 = 0;
  for (size_t i = 0; i < it->second.size() && written < max_frames;
       i += stride) {
    ImageView v;
    if (!parse_image(it->second[i], v)) return -2;
    if (written == 0) {
      H0 = v.height;
      W0 = v.width;
      step0 = v.step;
      frame_bytes = static_cast<size_t>(v.height) * v.step;
    } else if (v.height != H0 || v.width != W0 || v.step != step0) {
      return -3;  // inconsistent geometry mid-topic
    }
    if (v.pixel_len < frame_bytes) return -4;
    std::memcpy(out + written * frame_bytes, v.pixels, frame_bytes);
    stamps[written] = v.stamp;
    ++written;
  }
  return written;
}

}  // extern "C"
