// Native dataset loader + prefetch queue for DR-SLAM-TPU.
//
// Role of the reference's host-side frame feed: the dataset runner
// (Examples/RGB-D/main.cc) reads PNG pairs synchronously on the tracking
// thread; under ROS, message_filters do buffered delivery (main_ros.cc).
// Here a C++ loader thread decodes TUM 16-bit depth / 8-bit gray PNGs and
// fills a lock-free-ish ring of pinned host buffers so the Python
// orchestrator never blocks on IO while the TPU is busy.
//
// PNG decoding is implemented directly (no libpng dependency): the TUM
// dataset PNGs use non-interlaced 8/16-bit grayscale or 8-bit RGB, zlib
// deflate streams -- a compact inflate + unfilter is included.
//
// Exposed C API (ctypes):
//   loader_open(paths, n, w, h, depth_factor, queue_cap) -> handle
//   loader_next(handle, gray_out, depth_out)             -> frame idx or -1
//   loader_close(handle)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Image {
  int w = 0, h = 0, channels = 0, bit_depth = 0;
  std::vector<uint8_t> data;  // raw scanlines after unfiltering
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Minimal PNG reader: non-interlaced gray8 / gray16 / rgb8.
bool read_png(const std::string& path, Image* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n);
  if (fread(buf.data(), 1, n, f) != size_t(n)) { fclose(f); return false; }
  fclose(f);
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (n < 8 || memcmp(buf.data(), magic, 8) != 0) return false;

  std::vector<uint8_t> idat;
  size_t off = 8;
  int color_type = -1;
  while (off + 8 <= size_t(n)) {
    uint32_t len = rd_u32(&buf[off]);
    const char* tag = reinterpret_cast<const char*>(&buf[off + 4]);
    const uint8_t* payload = &buf[off + 8];
    if (!strncmp(tag, "IHDR", 4)) {
      out->w = rd_u32(payload);
      out->h = rd_u32(payload + 4);
      out->bit_depth = payload[8];
      color_type = payload[9];
      if (payload[12] != 0) return false;  // interlaced unsupported
      out->channels = (color_type == 2) ? 3 : 1;
    } else if (!strncmp(tag, "IDAT", 4)) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (!strncmp(tag, "IEND", 4)) {
      break;
    }
    off += 12 + len;
  }
  if (out->w <= 0 || idat.empty()) return false;
  if (color_type != 0 && color_type != 2) return false;

  int bytes_pp = out->channels * out->bit_depth / 8;
  size_t stride = size_t(out->w) * bytes_pp;
  std::vector<uint8_t> raw((stride + 1) * out->h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK)
    return false;

  out->data.assign(stride * out->h, 0);
  std::vector<uint8_t> prev(stride, 0);
  for (int y = 0; y < out->h; ++y) {
    uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = &raw[(stride + 1) * y + 1];
    uint8_t* dst = &out->data[stride * y];
    for (size_t x = 0; x < stride; ++x) {
      int a = (x >= size_t(bytes_pp)) ? dst[x - bytes_pp] : 0;
      int b = prev[x];
      int c = (x >= size_t(bytes_pp)) ? prev[x - bytes_pp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = uint8_t(v);
    }
    memcpy(prev.data(), dst, stride);
  }
  return true;
}

struct Frame {
  int index;
  int error = 0;  // bit 0: gray decode failed, bit 1: depth decode failed
  std::vector<float> gray;   // H*W in [0,255]
  std::vector<float> depth;  // H*W meters
};

struct Loader {
  int w, h, cap;
  float depth_factor;
  std::vector<std::string> gray_paths, depth_paths;
  std::queue<Frame> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<bool> done{false};
  std::thread worker;

  void run() {
    for (size_t i = 0; i < gray_paths.size() && !done.load(); ++i) {
      Frame fr;
      fr.index = int(i);
      fr.gray.assign(size_t(w) * h, 0.f);
      fr.depth.assign(size_t(w) * h, 0.f);
      Image gi, di;
      bool gray_ok = false;
      if (read_png(gray_paths[i], &gi) && gi.w == w && gi.h == h) {
        if (gi.channels == 1 && gi.bit_depth == 8) {
          for (int p = 0; p < w * h; ++p) fr.gray[p] = gi.data[p];
          gray_ok = true;
        } else if (gi.channels == 3 && gi.bit_depth == 8) {
          for (int p = 0; p < w * h; ++p) {
            // BGR->gray weights matching the reference's cvtColor use
            fr.gray[p] = 0.299f * gi.data[3 * p] + 0.587f * gi.data[3 * p + 1]
                        + 0.114f * gi.data[3 * p + 2];
          }
          gray_ok = true;
        }
      }
      bool depth_ok = false;
      if (read_png(depth_paths[i], &di) && di.w == w && di.h == h &&
          di.bit_depth == 16 && di.channels == 1) {
        for (int p = 0; p < w * h; ++p) {
          uint16_t v = (uint16_t(di.data[2 * p]) << 8) | di.data[2 * p + 1];
          fr.depth[p] = float(v) / depth_factor;
        }
        depth_ok = true;
      }
      // A corrupt/unsupported PNG (palette, interlaced, truncated) must NOT
      // silently feed black frames into tracking: flag it for the caller.
      fr.error = (gray_ok ? 0 : 1) | (depth_ok ? 0 : 2);
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return int(queue.size()) < cap || done.load(); });
      if (done.load()) return;
      queue.push(std::move(fr));
      cv_pop.notify_one();
    }
    std::lock_guard<std::mutex> lk(mu);
    done.store(true);
    cv_pop.notify_all();
  }
};

}  // namespace

extern "C" {

void* loader_open(const char** gray_paths, const char** depth_paths, int n,
                  int w, int h, float depth_factor, int queue_cap) {
  auto* l = new Loader();
  l->w = w;
  l->h = h;
  l->cap = queue_cap > 0 ? queue_cap : 4;
  l->depth_factor = depth_factor;
  for (int i = 0; i < n; ++i) {
    l->gray_paths.emplace_back(gray_paths[i]);
    l->depth_paths.emplace_back(depth_paths[i]);
  }
  l->worker = std::thread([l] { l->run(); });
  return l;
}

// err_out (may be null): 0 = ok, bit 0 = gray decode failed, bit 1 = depth
// decode failed. Returns the frame index, or -1 at end of stream.
int loader_next_ex(void* handle, float* gray_out, float* depth_out,
                   int* err_out) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv_pop.wait(lk, [&] { return !l->queue.empty() || l->done.load(); });
  if (l->queue.empty()) return -1;
  Frame fr = std::move(l->queue.front());
  l->queue.pop();
  l->cv_push.notify_one();
  lk.unlock();
  memcpy(gray_out, fr.gray.data(), fr.gray.size() * sizeof(float));
  memcpy(depth_out, fr.depth.data(), fr.depth.size() * sizeof(float));
  if (err_out) *err_out = fr.error;
  return fr.index;
}

int loader_next(void* handle, float* gray_out, float* depth_out) {
  return loader_next_ex(handle, gray_out, depth_out, nullptr);
}

void loader_close(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->done.store(true);
  l->cv_push.notify_all();
  l->cv_pop.notify_all();
  if (l->worker.joinable()) l->worker.join();
  delete l;
}

}  // extern "C"
