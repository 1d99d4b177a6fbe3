// Native JPEG decode + resize + center-crop + normalize core.
//
// The reference hides frame decode inside 6 torch DataLoader workers per
// GPU (pretraining/generative/pretrain_videomae.py:204,230-235); on TPU
// hosts the input pipeline is the likeliest bottleneck (SURVEY.md §7
// "hard parts", §2.11 native-dependency ledger).  This core fuses the
// whole per-frame host path — libjpeg decode, bilinear shorter-side
// resize, center crop, (x/255 - 0.5)/0.25 normalize — into one C++ call
// over a frame batch, with an internal thread pool so a single Python
// call decodes a full clip without GIL round-trips.
//
// Exposed C ABI (consumed via ctypes in bvc_tpu_torch/native/__init__.py;
// the same source and ABI as bvc_tpu/native/decode.cpp):
//   bvc_decode_frames(paths, n, image_size, out, n_threads) -> 0 on
//   success, else the (1-based) index of the first failed path.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decode one JPEG into an RGB8 buffer. Returns true on success.
//
// When the caller will downscale to `target_short` anyway, uses libjpeg's
// DCT-domain scaling (scale_num/8) to decode directly at reduced
// resolution — skips most of the IDCT work, which dominates decode time.
// The decoded shorter side is kept >= target_short so the later bilinear
// pass only ever downsamples slightly.
bool decode_jpeg(const char* path, std::vector<unsigned char>& rgb, int& w,
                 int& h, int target_short = 0) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (target_short > 0) {
    const int short_side = cinfo.image_width < cinfo.image_height
                               ? cinfo.image_width
                               : cinfo.image_height;
    int num = 8;
    while (num > 1 && short_side * (num - 1) / 8 >= target_short) --num;
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
  }
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  rgb.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Bilinear sample of channel c at (x, y) from an RGB8 image.
inline float bilinear(const unsigned char* img, int w, int h, float x, float y,
                      int c) {
  int x0 = static_cast<int>(x);
  int y0 = static_cast<int>(y);
  int x1 = x0 + 1 < w ? x0 + 1 : x0;
  int y1 = y0 + 1 < h ? y0 + 1 : y0;
  float fx = x - x0, fy = y - y0;
  const float p00 = img[(static_cast<size_t>(y0) * w + x0) * 3 + c];
  const float p01 = img[(static_cast<size_t>(y0) * w + x1) * 3 + c];
  const float p10 = img[(static_cast<size_t>(y1) * w + x0) * 3 + c];
  const float p11 = img[(static_cast<size_t>(y1) * w + x1) * 3 + c];
  return p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy) +
         p10 * (1 - fx) * fy + p11 * fx * fy;
}

// Decode + shorter-side resize + center crop, uint8 output (device-side
// normalization path).
bool process_one_u8(const char* path, int size, unsigned char* out,
                    bool dct_scale) {
  std::vector<unsigned char> rgb;
  int w = 0, h = 0;
  if (!decode_jpeg(path, rgb, w, h, dct_scale ? size : 0)) return false;
  const float scale = static_cast<float>(size) / (w < h ? w : h);
  const int rw = static_cast<int>(std::lround(w * scale));
  const int rh = static_cast<int>(std::lround(h * scale));
  const int ox = (rw - size) / 2;
  const int oy = (rh - size) / 2;
  const float rx = static_cast<float>(w) / rw;
  const float ry = static_cast<float>(h) / rh;
  for (int y = 0; y < size; ++y) {
    float sy = (y + oy + 0.5f) * ry - 0.5f;
    if (sy < 0) sy = 0;
    if (sy > h - 1) sy = static_cast<float>(h - 1);
    for (int x = 0; x < size; ++x) {
      float sx = (x + ox + 0.5f) * rx - 0.5f;
      if (sx < 0) sx = 0;
      if (sx > w - 1) sx = static_cast<float>(w - 1);
      unsigned char* px = out + (static_cast<size_t>(y) * size + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float v = bilinear(rgb.data(), w, h, sx, sy, c);
        px[c] = static_cast<unsigned char>(v + 0.5f);
      }
    }
  }
  return true;
}

// Decode + shorter-side resize + center crop to size x size + normalize.
bool process_one(const char* path, int size, float* out, bool dct_scale) {
  std::vector<unsigned char> rgb;
  int w = 0, h = 0;
  if (!decode_jpeg(path, rgb, w, h, dct_scale ? size : 0)) return false;
  // shorter-side scale
  const float scale = static_cast<float>(size) / (w < h ? w : h);
  const int rw = static_cast<int>(std::lround(w * scale));
  const int rh = static_cast<int>(std::lround(h * scale));
  // center-crop offsets in resized space
  const int ox = (rw - size) / 2;
  const int oy = (rh - size) / 2;
  // per-axis src/dst ratios — the rounding of rw/rh makes these differ
  // slightly from 1/scale, and cv2 INTER_LINEAR uses the exact ratios
  const float rx = static_cast<float>(w) / rw;
  const float ry = static_cast<float>(h) / rh;
  constexpr float kInv255 = 1.0f / 255.0f;
  constexpr float kMean = 0.5f, kInvStd = 4.0f;  // std 0.25
  for (int y = 0; y < size; ++y) {
    // map output pixel back to source coords (align like cv2 INTER_LINEAR)
    float sy = (y + oy + 0.5f) * ry - 0.5f;
    if (sy < 0) sy = 0;
    if (sy > h - 1) sy = static_cast<float>(h - 1);
    for (int x = 0; x < size; ++x) {
      float sx = (x + ox + 0.5f) * rx - 0.5f;
      if (sx < 0) sx = 0;
      if (sx > w - 1) sx = static_cast<float>(w - 1);
      float* px = out + (static_cast<size_t>(y) * size + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float v = bilinear(rgb.data(), w, h, sx, sy, c) * kInv255;
        px[c] = (v - kMean) * kInvStd;
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Returns 0 on success; on failure, 1-based index of the first bad path.
int bvc_decode_frames(const char** paths, int n, int image_size, float* out,
                      int n_threads, int dct_scale) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      float* dst = out + static_cast<size_t>(i) * image_size * image_size * 3;
      if (!process_one(paths[i], image_size, dst, dct_scale != 0)) {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
      }
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return failed.load();
}

// uint8 variant; same return convention.
int bvc_decode_frames_u8(const char** paths, int n, int image_size,
                         unsigned char* out, int n_threads, int dct_scale) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      unsigned char* dst =
          out + static_cast<size_t>(i) * image_size * image_size * 3;
      if (!process_one_u8(paths[i], image_size, dst, dct_scale != 0)) {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
      }
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return failed.load();
}

int bvc_version() { return 2; }
}
