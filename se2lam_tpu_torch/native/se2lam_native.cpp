// Native dataset loader: BMP decode + threaded prefetch ring.
//
// TPU-native counterpart of the reference's C++ feed path (test_vn's
// imread loop, test/test_vn.cpp:43-55): image decode and file IO are
// host-side runtime work that should not sit on the Python interpreter
// thread while the device pipeline runs. A small worker pool decodes
// frames ahead into a bounded ring; the Python side pops finished
// frames through a ctypes API.
//
// Supports uncompressed 8-bit palette and 24/32-bit BMP (the DatasetRoom
// format), converted to uint8 grayscale (1 byte/px — frames ship to
// the device in source dtype; f32 cast happens on-device).
//
// Build: g++ -O2 -shared -fPIC -o libse2lam_native.so se2lam_native.cpp -lpthread

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int index = -1;
  int h = 0, w = 0;
  std::vector<uint8_t> pix;
  bool ok = false;
};

#pragma pack(push, 1)
struct BmpFileHeader {
  uint16_t type;
  uint32_t size;
  uint16_t r1, r2;
  uint32_t off_bits;
};
struct BmpInfoHeader {
  uint32_t size;
  int32_t width;
  int32_t height;
  uint16_t planes;
  uint16_t bit_count;
  uint32_t compression;
  uint32_t size_image;
  int32_t xppm, yppm;
  uint32_t clr_used, clr_important;
};
#pragma pack(pop)

bool decode_bmp_gray(const std::string& path, Image* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  BmpFileHeader fh;
  BmpInfoHeader ih;
  if (std::fread(&fh, sizeof fh, 1, f) != 1 ||
      std::fread(&ih, sizeof ih, 1, f) != 1 || fh.type != 0x4D42 ||
      ih.compression != 0) {
    std::fclose(f);
    return false;
  }
  const int w = ih.width;
  const bool flip = ih.height > 0;
  const int h = flip ? ih.height : -ih.height;
  const int bpp = ih.bit_count;
  // bound header-declared sizes: a malformed file must fail decode, not
  // throw bad_alloc through the extern-C boundary / a worker thread
  constexpr int64_t kMaxPixels = int64_t(1) << 26;  // 64 Mpix
  if (w <= 0 || h <= 0 || (int64_t)w * h > kMaxPixels ||
      (bpp != 8 && bpp != 24 && bpp != 32)) {
    std::fclose(f);
    return false;
  }

  // palette for 8-bit (grayscale value = luma of the palette entry).
  // Always 256 entries: pixel bytes index the full range even when the
  // file declares fewer colors (legal truncated palettes).
  std::vector<uint8_t> palette;
  if (bpp == 8) {
    uint32_t n = ih.clr_used ? ih.clr_used : 256;
    if (n > 256) n = 256;
    std::vector<uint8_t> pal(n * 4);
    std::fseek(f, sizeof fh + ih.size, SEEK_SET);
    if (std::fread(pal.data(), 4, n, f) != n) {
      std::fclose(f);
      return false;
    }
    palette.assign(256, 0);
    for (uint32_t i = 0; i < n; ++i) {
      const float luma = 0.114f * pal[4 * i] + 0.587f * pal[4 * i + 1] +
                         0.299f * pal[4 * i + 2];
      palette[i] = (uint8_t)(luma + 0.5f);
    }
  }

  const int bytes_pp = bpp / 8;
  const size_t stride = ((size_t)w * bytes_pp + 3) & ~size_t(3);
  std::vector<uint8_t> row(stride);
  out->pix.assign((size_t)w * h, 0);
  std::fseek(f, fh.off_bits, SEEK_SET);
  for (int r = 0; r < h; ++r) {
    if (std::fread(row.data(), 1, stride, f) != stride) {
      std::fclose(f);
      return false;
    }
    const int y = flip ? (h - 1 - r) : r;
    uint8_t* dst = out->pix.data() + (size_t)y * w;
    if (bpp == 8) {
      for (int x = 0; x < w; ++x) dst[x] = palette[row[x]];
    } else {
      for (int x = 0; x < w; ++x) {
        const uint8_t* p = row.data() + (size_t)x * bytes_pp;
        const float luma =
            0.114f * p[0] + 0.587f * p[1] + 0.299f * p[2];  // BGR
        dst[x] = (uint8_t)(luma + 0.5f);
      }
    }
  }
  std::fclose(f);
  out->h = h;
  out->w = w;
  out->ok = true;
  return true;
}

struct Loader {
  std::string dir;
  int start, count, ring_cap;
  std::vector<Image> ring;       // completed frames, ordered by index
  int next_decode;               // next index to hand to a worker
  int next_pop;                  // next index the consumer expects
  std::mutex mu;
  std::condition_variable cv_room, cv_ready;
  std::vector<std::thread> workers;
  bool stop = false;

  Loader(const char* d, int s, int c, int threads, int cap)
      : dir(d), start(s), count(c), ring_cap(cap), next_decode(s),
        next_pop(s) {
    for (int i = 0; i < threads; ++i)
      workers.emplace_back([this] { this->run(); });
  }

  void run() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_room.wait(lk, [&] {
          return stop || (next_decode < start + count &&
                          next_decode - next_pop < ring_cap);
        });
        if (stop || next_decode >= start + count) return;
        idx = next_decode++;
      }
      Image img;
      img.index = idx;
      char path[4096];
      std::snprintf(path, sizeof path, "%s/%d.bmp", dir.c_str(), idx);
      try {
        decode_bmp_gray(path, &img);
      } catch (...) {
        img.ok = false;  // decode failure, not process abort
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ring.push_back(std::move(img));
        cv_ready.notify_all();
      }
    }
  }

  // returns h<<32 | w on success, 0 on decode failure, -1 at end
  int64_t pop(uint8_t* out, int64_t cap_elems) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_pop >= start + count) return -1;
    const int want = next_pop;
    cv_ready.wait(lk, [&] {
      for (auto& im : ring)
        if (im.index == want) return true;
      return false;
    });
    for (size_t i = 0; i < ring.size(); ++i) {
      if (ring[i].index == want) {
        Image im = std::move(ring[i]);
        ring.erase(ring.begin() + i);
        ++next_pop;
        cv_room.notify_all();
        lk.unlock();
        if (!im.ok) return 0;
        const int64_t n = (int64_t)im.h * im.w;
        if (n > cap_elems) return 0;
        std::memcpy(out, im.pix.data(), n);
        return ((int64_t)im.h << 32) | (uint32_t)im.w;
      }
    }
    return 0;  // unreachable
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
      cv_room.notify_all();
    }
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

void* dl_open(const char* dir, int start, int count, int threads,
              int ring_cap) {
  if (threads < 1) threads = 1;
  if (ring_cap < 1) ring_cap = 4;
  return new Loader(dir, start, count, threads, ring_cap);
}

// out must hold cap_elems uint8; returns (h<<32|w), 0 on failure, -1 at end
int64_t dl_next(void* h, uint8_t* out, int64_t cap_elems) {
  return static_cast<Loader*>(h)->pop(out, cap_elems);
}

void dl_close(void* h) { delete static_cast<Loader*>(h); }

// one-shot synchronous decode (no threads)
int64_t dl_decode_bmp(const char* path, uint8_t* out, int64_t cap_elems) {
  try {
    Image im;
    if (!decode_bmp_gray(path, &im)) return 0;
    const int64_t n = (int64_t)im.h * im.w;
    if (n > cap_elems) return 0;
    std::memcpy(out, im.pix.data(), n);
    return ((int64_t)im.h << 32) | (uint32_t)im.w;
  } catch (...) {
    return 0;
  }
}

}  // extern "C"
