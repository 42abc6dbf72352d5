// Adaptive binary range coder for latent / DCT-coefficient bitstreams.
//
// The reference never serializes anything -- its "compression" is analytic
// bits-per-pixel accounting over latent dimensionality (GAN_test.py:314-325) and
// its only real encoder is libjpeg behind cv2.imwrite (test_autoencoder.py:93).
// This module is the framework's native entropy-coding tier: a 32-bit adaptive
// binary range coder (CABAC-style, carry-less renormalization) with
// exponential-Golomb binarization of int16 symbols and small per-bit-position
// context sets. It turns the DCT baseline codec and the GAN codec's quantized
// latents into REAL bitstreams with measured sizes.
//
// Built as a shared library; Python binds via ctypes (see native/__init__.py).
// Zero dependencies, single translation unit, -O3.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------------- bit model
// 11-bit probability of bit==0, shift-5 adaptation (the LZMA constants).
constexpr int kProbBits = 11;
constexpr int kProbInit = 1 << (kProbBits - 1);  // 1024
constexpr int kMoveBits = 5;
constexpr uint32_t kTopValue = 1u << 24;

struct BitModel {
  uint16_t p0 = kProbInit;  // P(bit == 0) * 2^11
};

// -------------------------------------------------------------- range coder
// Canonical LZMA-style carry-propagating range coder.
class RangeEncoder {
 public:
  explicit RangeEncoder(std::vector<uint8_t>* out) : out_(out) {}

  inline void encode_bit(BitModel& m, int bit) {
    const uint32_t bound = (range_ >> kProbBits) * m.p0;
    if (bit == 0) {
      range_ = bound;
      m.p0 += ((1 << kProbBits) - m.p0) >> kMoveBits;
    } else {
      low_ += bound;
      range_ -= bound;
      m.p0 -= m.p0 >> kMoveBits;
    }
    while (range_ < kTopValue) {
      shift_low();
      range_ <<= 8;
    }
  }

  void flush() {
    for (int i = 0; i < 5; ++i) shift_low();
  }

 private:
  inline void shift_low() {
    if ((uint32_t)low_ < 0xFF000000u || (unsigned)(low_ >> 32) != 0) {
      uint8_t temp = cache_;
      do {
        out_->push_back((uint8_t)(temp + (uint8_t)(low_ >> 32)));
        temp = 0xFF;
      } while (--cache_size_ != 0);
      cache_ = (uint8_t)(low_ >> 24);
    }
    ++cache_size_;
    low_ = (uint32_t)low_ << 8;
  }

  std::vector<uint8_t>* out_;
  uint64_t low_ = 0;
  uint32_t range_ = 0xFFFFFFFFu;
  uint8_t cache_ = 0;
  uint64_t cache_size_ = 1;
};

class RangeDecoder {
 public:
  RangeDecoder(const uint8_t* data, size_t n) : data_(data), n_(n) {
    for (int i = 0; i < 5; ++i) code_ = (code_ << 8) | next_byte();
  }

  inline int decode_bit(BitModel& m) {
    const uint32_t bound = (range_ >> kProbBits) * m.p0;
    int bit;
    if (code_ < bound) {
      bit = 0;
      range_ = bound;
      m.p0 += ((1 << kProbBits) - m.p0) >> kMoveBits;
    } else {
      bit = 1;
      code_ -= bound;
      range_ -= bound;
      m.p0 -= m.p0 >> kMoveBits;
    }
    while (range_ < kTopValue) {
      code_ = (code_ << 8) | next_byte();
      range_ <<= 8;
    }
    return bit;
  }

 private:
  inline uint8_t next_byte() { return pos_ < n_ ? data_[pos_++] : 0; }
  const uint8_t* data_;
  size_t n_;
  size_t pos_ = 0;
  uint32_t code_ = 0;
  uint32_t range_ = 0xFFFFFFFFu;
};

// ------------------------------------------------------------- binarization
// Contexts: [0] zero-flag, [1] sign, [2..17] unary magnitude-class bits,
// [18..33] exp-golomb suffix bits by position.
constexpr int kNumContexts = 34;

struct Contexts {
  BitModel m[kNumContexts];
};

// magnitude v >= 1 encoded as class k = floor(log2(v)) via unary, then k raw-ish
// suffix bits (each with its own adaptive model).
inline void encode_symbol(RangeEncoder& enc, Contexts& ctx, int32_t v) {
  if (v == 0) {
    enc.encode_bit(ctx.m[0], 0);
    return;
  }
  enc.encode_bit(ctx.m[0], 1);
  enc.encode_bit(ctx.m[1], v < 0 ? 1 : 0);
  uint32_t mag = (uint32_t)(v < 0 ? -v : v);
  int k = 0;
  while ((2u << k) <= mag) ++k;  // k = floor(log2(mag))
  for (int i = 0; i < k; ++i) enc.encode_bit(ctx.m[2 + (i < 15 ? i : 15)], 1);
  enc.encode_bit(ctx.m[2 + (k < 15 ? k : 15)], 0);
  for (int i = k - 1; i >= 0; --i)
    enc.encode_bit(ctx.m[18 + (i < 15 ? i : 15)], (mag >> i) & 1);
}

inline int32_t decode_symbol(RangeDecoder& dec, Contexts& ctx) {
  if (!dec.decode_bit(ctx.m[0])) return 0;
  const int sign = dec.decode_bit(ctx.m[1]);
  int k = 0;
  while (dec.decode_bit(ctx.m[2 + (k < 15 ? k : 15)])) ++k;
  uint32_t mag = 1;
  for (int i = k - 1; i >= 0; --i)
    mag = (mag << 1) | (uint32_t)dec.decode_bit(ctx.m[18 + (i < 15 ? i : 15)]);
  return sign ? -(int32_t)mag : (int32_t)mag;
}

}  // namespace

extern "C" {

// Encode n int16 symbols; returns bytes written, or 0 if out_cap too small.
size_t cic_entropy_encode(const int16_t* in, size_t n, uint8_t* out,
                          size_t out_cap) {
  std::vector<uint8_t> buf;
  buf.reserve(n / 2 + 64);
  Contexts ctx;
  RangeEncoder enc(&buf);
  for (size_t i = 0; i < n; ++i) encode_symbol(enc, ctx, in[i]);
  enc.flush();
  if (buf.size() > out_cap) return 0;
  std::memcpy(out, buf.data(), buf.size());
  return buf.size();
}

// Decode n int16 symbols from a cic_entropy_encode stream. Returns n on success.
size_t cic_entropy_decode(const uint8_t* in, size_t nbytes, int16_t* out,
                          size_t n) {
  Contexts ctx;
  RangeDecoder dec(in, nbytes);
  for (size_t i = 0; i < n; ++i) {
    int32_t v = decode_symbol(dec, ctx);
    if (v < -32768 || v > 32767) return i;
    out[i] = (int16_t)v;
  }
  return n;
}

// Threaded batch encode: `batch` items of n_per_item symbols, one independent
// stream per item (so items decode independently), laid out as
// [uint32 length][bytes] per item in `out`. Returns total bytes used, or 0 on
// overflow.
size_t cic_entropy_encode_batch(const int16_t* in, size_t batch,
                                size_t n_per_item, uint8_t* out,
                                size_t out_cap, int num_threads) {
  std::vector<std::vector<uint8_t>> streams(batch);
  if (num_threads < 1) num_threads = 1;
  if ((size_t)num_threads > batch) num_threads = (int)batch;

  std::atomic<size_t> next{0};
  auto worker = [&]() {
    for (;;) {
      size_t b = next.fetch_add(1);
      if (b >= batch) break;
      Contexts ctx;
      RangeEncoder enc(&streams[b]);
      const int16_t* item = in + b * n_per_item;
      for (size_t i = 0; i < n_per_item; ++i) encode_symbol(enc, ctx, item[i]);
      enc.flush();
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < num_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();

  size_t offset = 0;
  for (size_t b = 0; b < batch; ++b) {
    if (offset + 4 + streams[b].size() > out_cap) return 0;
    uint32_t len = (uint32_t)streams[b].size();
    std::memcpy(out + offset, &len, 4);
    std::memcpy(out + offset + 4, streams[b].data(), streams[b].size());
    offset += 4 + streams[b].size();
  }
  return offset;
}

// Threaded batch decode: inverse of cic_entropy_encode_batch. `in` holds `batch`
// [uint32 length][bytes] frames; writes batch*n_per_item symbols to `out`.
// Returns the number of items fully decoded (== batch on success; stops early on
// a truncated frame or an out-of-range symbol).
size_t cic_entropy_decode_batch(const uint8_t* in, size_t nbytes, size_t batch,
                                size_t n_per_item, int16_t* out,
                                int num_threads) {
  // frame scan is sequential (lengths chain), decode is parallel
  std::vector<std::pair<const uint8_t*, size_t>> frames;
  frames.reserve(batch);
  size_t offset = 0;
  for (size_t b = 0; b < batch; ++b) {
    if (offset + 4 > nbytes) return b;
    uint32_t len;
    std::memcpy(&len, in + offset, 4);
    if (offset + 4 + len > nbytes) return b;
    frames.emplace_back(in + offset + 4, (size_t)len);
    offset += 4 + len;
  }

  if (num_threads < 1) num_threads = 1;
  if ((size_t)num_threads > batch) num_threads = (int)batch;
  std::atomic<size_t> next{0};
  std::atomic<size_t> ok_items{0};
  auto worker = [&]() {
    for (;;) {
      size_t b = next.fetch_add(1);
      if (b >= batch) break;
      Contexts ctx;
      RangeDecoder dec(frames[b].first, frames[b].second);
      int16_t* item = out + b * n_per_item;
      bool ok = true;
      for (size_t i = 0; i < n_per_item; ++i) {
        int32_t v = decode_symbol(dec, ctx);
        if (v < -32768 || v > 32767) { ok = false; break; }
        item[i] = (int16_t)v;
      }
      if (ok) ok_items.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < num_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return ok_items.load();
}

}  // extern "C"
