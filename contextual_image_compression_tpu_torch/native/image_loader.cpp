// Multithreaded native image loader: JPEG/PNG decode + bilinear resize +
// normalize, straight into a preallocated float32 batch buffer.
//
// The port's copy of the JAX package's native/image_loader.cpp, the same
// code, so both packages load bitwise-equal batches. A std::thread pool
// decodes with libjpeg/libpng, resizes bilinearly (half-pixel centers,
// cv2.INTER_LINEAR convention) and writes normalized float32 directly into
// the caller's batch array, which the Python side hands to torch as it is.
//
// C API (ctypes-bound in native/__init__.py):
//   cic_load_images(paths, n, th, tw, out, normalization, threads, ok_flags)
//     normalization: 0 -> [0,1] (AE convention), 1 -> [-1,1] (GAN convention)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  std::vector<uint8_t> rgb;  // H*W*3
  int h = 0, w = 0;
};

// ------------------------------------------------------------------- JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

bool decode_jpeg(const uint8_t* data, size_t n, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), n);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize((size_t)out->w * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + (size_t)cinfo.output_scanline * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// -------------------------------------------------------------------- PNG
struct PngReadState {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t count) {
  PngReadState* s = (PngReadState*)png_get_io_ptr(png);
  if (s->pos + count > s->size) {
    png_error(png, "eof");
    return;
  }
  std::memcpy(out, s->data + s->pos, count);
  s->pos += count;
}

bool decode_png(const uint8_t* data, size_t n, Image* out) {
  if (n < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState state{data, n, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);

  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);

  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  const size_t rowbytes = png_get_rowbytes(png, info);
  if (rowbytes < (size_t)out->w * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  std::vector<uint8_t> raw((size_t)out->h * rowbytes);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y) rows[y] = raw.data() + (size_t)y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);

  out->rgb.resize((size_t)out->w * out->h * 3);
  for (int y = 0; y < out->h; ++y)
    std::memcpy(out->rgb.data() + (size_t)y * out->w * 3,
                raw.data() + (size_t)y * rowbytes, (size_t)out->w * 3);
  return true;
}

// --------------------------------------------------------- resize+normalize
// Bilinear with half-pixel centers (cv2.INTER_LINEAR convention), fused with
// normalization into the caller's float32 buffer.
void resize_normalize(const Image& img, int th, int tw, float* out,
                      int normalization) {
  const float sy = (float)img.h / th;
  const float sx = (float)img.w / tw;
  const float scale = normalization == 1 ? 1.0f / 127.5f : 1.0f / 255.0f;
  const float shift = normalization == 1 ? -1.0f : 0.0f;
  for (int y = 0; y < th; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)fy;
    if (fy < 0) { fy = 0; y0 = 0; }
    int y1 = y0 + 1 < img.h ? y0 + 1 : img.h - 1;
    const float wy = fy - y0;
    for (int x = 0; x < tw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)fx;
      if (fx < 0) { fx = 0; x0 = 0; }
      int x1 = x0 + 1 < img.w ? x0 + 1 : img.w - 1;
      const float wx = fx - x0;
      const uint8_t* p00 = &img.rgb[((size_t)y0 * img.w + x0) * 3];
      const uint8_t* p01 = &img.rgb[((size_t)y0 * img.w + x1) * 3];
      const uint8_t* p10 = &img.rgb[((size_t)y1 * img.w + x0) * 3];
      const uint8_t* p11 = &img.rgb[((size_t)y1 * img.w + x1) * 3];
      float* dst = out + ((size_t)y * tw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] + (p01[c] - p00[c]) * wx;
        const float bot = p10[c] + (p11[c] - p10[c]) * wx;
        const float v = top + (bot - top) * wy;
        dst[c] = v * scale + shift;
      }
    }
  }
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    std::fclose(f);
    return false;
  }
  out->resize((size_t)n);
  size_t got = std::fread(out->data(), 1, (size_t)n, f);
  std::fclose(f);
  return got == (size_t)n;
}

}  // namespace

extern "C" {

// Returns the number of successfully loaded images. ok_flags[i] records per-file
// success; failed slots are zero-filled (callers can compact).
size_t cic_load_images(const char** paths, size_t n, int target_h, int target_w,
                       float* out, int normalization, int num_threads,
                       int* ok_flags) {
  if (num_threads < 1) num_threads = 1;
  if ((size_t)num_threads > n) num_threads = (int)n;
  std::atomic<size_t> next{0};
  std::atomic<size_t> loaded{0};
  const size_t stride = (size_t)target_h * target_w * 3;

  auto worker = [&]() {
    std::vector<uint8_t> buf;
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= n) break;
      float* dst = out + i * stride;
      Image img;
      bool ok = read_file(paths[i], &buf) &&
                (decode_jpeg(buf.data(), buf.size(), &img) ||
                 decode_png(buf.data(), buf.size(), &img)) &&
                img.w > 0 && img.h > 0;
      if (ok) {
        resize_normalize(img, target_h, target_w, dst, normalization);
        loaded.fetch_add(1);
      } else {
        std::memset(dst, 0, stride * sizeof(float));
      }
      if (ok_flags) ok_flags[i] = ok ? 1 : 0;
    }
  };

  std::vector<std::thread> threads;
  for (int t = 1; t < num_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return loaded.load();
}

}  // extern "C"
