// LASzip codec — native implementation for pasture_tpu.
//
// Replaces the pure-Rust `laz` crate the reference depends on
// (pasture-io uses laz::LasZipDecompressor / LasZipCompressor,
// raw_readers.rs:418-660).  Implements the LASzip 2.x "pointwise chunked"
// scheme (compressor 2: Amir Said's FastAC range coder with adaptive
// bit/symbol models, the k-bit corrector IntegerCompressor, and the item
// codecs POINT10 v2, GPSTIME11 v2, RGB12 v2, WAVEPACKET13 v1, BYTE v2)
// and the LAS 1.4 "layered" scheme (compressor 3: POINT14 / RGB14 /
// RGBNIR14 / BYTE14 all v3, independent range coder per field layer,
// scanner-channel contexts).  Chunks are independent, so decompression
// fans out over host threads (SURVEY.md §7 hard part (d)).
//
// Exposed as a small extern "C" surface driven from Python via ctypes
// (pasture_tpu/native/laszip.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <memory>
#include <vector>
#include <thread>
#include <algorithm>

namespace {

typedef uint8_t U8;
typedef uint16_t U16;
typedef uint32_t U32;
typedef uint64_t U64;
typedef int8_t I8;
typedef int16_t I16;
typedef int32_t I32;
typedef int64_t I64;

constexpr U32 AC_MIN_LENGTH = 0x01000000u;
constexpr U32 AC_MAX_LENGTH = 0xFFFFFFFFu;
constexpr U32 BM_LENGTH_SHIFT = 13;
constexpr U32 BM_MAX_COUNT = 1u << BM_LENGTH_SHIFT;
constexpr U32 DM_LENGTH_SHIFT = 15;
constexpr U32 DM_MAX_COUNT = 1u << DM_LENGTH_SHIFT;

// ---------------------------------------------------------------- models ----

struct ArithmeticBitModel {
  U32 bit_0_prob, bit_0_count, bit_count, update_cycle, bits_until_update;

  void init() {
    bit_0_count = 1;
    bit_count = 2;
    bit_0_prob = 1u << (BM_LENGTH_SHIFT - 1);
    update_cycle = bits_until_update = 4;
  }

  void update() {
    if ((bit_count += update_cycle) > BM_MAX_COUNT) {
      bit_count = (bit_count + 1) >> 1;
      bit_0_count = (bit_0_count + 1) >> 1;
      if (bit_0_count == bit_count) ++bit_count;
    }
    U32 scale = 0x80000000u / bit_count;
    bit_0_prob = (bit_0_count * scale) >> (31 - BM_LENGTH_SHIFT);
    update_cycle = (5 * update_cycle) >> 2;
    if (update_cycle > 64) update_cycle = 64;
    bits_until_update = update_cycle;
  }
};

struct ArithmeticModel {
  std::vector<U32> distribution, symbol_count, decoder_table;
  U32 symbols = 0, total_count = 0, update_cycle = 0, symbols_until_update = 0;
  U32 last_symbol = 0, table_size = 0, table_shift = 0;
  bool compress = false;

  void init(U32 nsymbols, bool for_compress) {
    symbols = nsymbols;
    compress = for_compress;
    last_symbol = symbols - 1;
    distribution.assign(symbols, 0);
    symbol_count.assign(symbols, 1);
    if (!compress && symbols > 16) {
      U32 table_bits = 3;
      while (symbols > (1u << (table_bits + 2))) ++table_bits;
      table_size = 1u << table_bits;
      table_shift = DM_LENGTH_SHIFT - table_bits;
      decoder_table.assign(table_size + 2, 0);
    } else {
      table_size = table_shift = 0;
      decoder_table.clear();
    }
    total_count = 0;
    update_cycle = symbols;
    update();
    symbols_until_update = update_cycle = (symbols + 6) >> 1;
  }

  void update() {
    if ((total_count += update_cycle) > DM_MAX_COUNT) {
      total_count = 0;
      for (U32 k = 0; k < symbols; k++)
        total_count += (symbol_count[k] = (symbol_count[k] + 1) >> 1);
    }
    U32 sum = 0, s = 0;
    U32 scale = 0x80000000u / total_count;
    if (compress || table_size == 0) {
      for (U32 k = 0; k < symbols; k++) {
        distribution[k] = (scale * sum) >> (31 - DM_LENGTH_SHIFT);
        sum += symbol_count[k];
      }
    } else {
      for (U32 k = 0; k < symbols; k++) {
        distribution[k] = (scale * sum) >> (31 - DM_LENGTH_SHIFT);
        sum += symbol_count[k];
        U32 w = distribution[k] >> table_shift;
        while (s < w) decoder_table[++s] = k - 1;
      }
      decoder_table[0] = 0;
      while (s <= table_size) decoder_table[++s] = symbols - 1;
    }
    update_cycle = (5 * update_cycle) >> 2;
    U32 max_cycle = (symbols + 6) << 3;
    if (update_cycle > max_cycle) update_cycle = max_cycle;
    symbols_until_update = update_cycle;
  }
};

// --------------------------------------------------------------- decoder ----

struct Decoder {
  const U8* buf;
  size_t pos, size;
  U32 value = 0, length = 0;
  bool overrun = false;

  U8 getByte() {
    if (pos >= size) {
      overrun = true;
      ++pos;
      return 0;
    }
    return buf[pos++];
  }

  void init() {
    value = (U32(getByte()) << 24) | (U32(getByte()) << 16) |
            (U32(getByte()) << 8) | U32(getByte());
    length = AC_MAX_LENGTH;
  }

  void renorm() {
    do {
      value = (value << 8) | getByte();
    } while ((length <<= 8) < AC_MIN_LENGTH);
  }

  U32 decodeBit(ArithmeticBitModel& m) {
    U32 x = m.bit_0_prob * (length >> BM_LENGTH_SHIFT);
    U32 sym = (value >= x);
    if (sym == 0) {
      length = x;
      ++m.bit_0_count;
    } else {
      value -= x;
      length -= x;
    }
    if (length < AC_MIN_LENGTH) renorm();
    if (--m.bits_until_update == 0) m.update();
    return sym;
  }

  U32 decodeSymbol(ArithmeticModel& m) {
    U32 n, sym, x, y = length;
    if (!m.decoder_table.empty()) {
      U32 dv = value / (length >>= DM_LENGTH_SHIFT);
      U32 t = dv >> m.table_shift;
      sym = m.decoder_table[t];
      n = m.decoder_table[t + 1] + 1;
      while (n > sym + 1) {
        U32 k = (sym + n) >> 1;
        if (m.distribution[k] > dv) n = k; else sym = k;
      }
      x = m.distribution[sym] * length;
      if (sym != m.last_symbol) y = m.distribution[sym + 1] * length;
    } else {
      x = sym = 0;
      length >>= DM_LENGTH_SHIFT;
      U32 k = (n = m.symbols) >> 1;
      do {
        U32 z = length * m.distribution[k];
        if (z > value) {
          n = k;
          y = z;
        } else {
          sym = k;
          x = z;
        }
      } while ((k = (sym + n) >> 1) != sym);
    }
    value -= x;
    length = y - x;
    if (length < AC_MIN_LENGTH) renorm();
    ++m.symbol_count[sym];
    if (--m.symbols_until_update == 0) m.update();
    return sym;
  }

  U32 readBits(U32 bits) {  // bits <= 19
    U32 sym = value / (length >>= bits);
    value -= sym * length;
    if (length < AC_MIN_LENGTH) renorm();
    return sym;
  }

  U32 readShort() { return readBits(16); }
  U32 readInt() {
    U32 lo = readShort();
    U32 hi = readShort();
    return (hi << 16) | lo;
  }
  U64 readInt64() {
    U64 lo = readInt();
    U64 hi = readInt();
    return (hi << 32) | lo;
  }
};

// --------------------------------------------------------------- encoder ----

struct Encoder {
  std::vector<U8> out;
  U32 base = 0, length = AC_MAX_LENGTH;

  void init() {
    base = 0;
    length = AC_MAX_LENGTH;
    out.clear();
  }

  void propagate_carry() {
    size_t p = out.size();
    while (p > 0 && out[p - 1] == 0xFF) out[--p] = 0;
    if (p > 0) ++out[p - 1];
  }

  void renorm() {
    do {
      out.push_back(U8(base >> 24));
      base <<= 8;
    } while ((length <<= 8) < AC_MIN_LENGTH);
  }

  void encodeBit(ArithmeticBitModel& m, U32 bit) {
    U32 x = m.bit_0_prob * (length >> BM_LENGTH_SHIFT);
    if (bit == 0) {
      length = x;
      ++m.bit_0_count;
    } else {
      U32 init_base = base;
      base += x;
      length -= x;
      if (init_base > base) propagate_carry();
    }
    if (length < AC_MIN_LENGTH) renorm();
    if (--m.bits_until_update == 0) m.update();
  }

  void encodeSymbol(ArithmeticModel& m, U32 sym) {
    U32 x, init_base = base;
    if (sym == m.last_symbol) {
      // NB: non-mutating shift — the last symbol's interval extends to the
      // full (unshifted) length, mirroring the decoder's y = length
      x = m.distribution[sym] * (length >> DM_LENGTH_SHIFT);
      base += x;
      length -= x;
    } else {
      x = m.distribution[sym] * (length >>= DM_LENGTH_SHIFT);
      base += x;
      length = m.distribution[sym + 1] * length - x;
    }
    if (init_base > base) propagate_carry();
    if (length < AC_MIN_LENGTH) renorm();
    ++m.symbol_count[sym];
    if (--m.symbols_until_update == 0) m.update();
  }

  void writeBits(U32 bits, U32 sym) {  // bits <= 19
    U32 init_base = base;
    base += sym * (length >>= bits);
    if (init_base > base) propagate_carry();
    if (length < AC_MIN_LENGTH) renorm();
  }

  void writeShort(U32 sym) { writeBits(16, sym); }
  void writeInt(U32 sym) {
    writeShort(sym & 0xFFFF);
    writeShort(sym >> 16);
  }
  void writeInt64(U64 sym) {
    writeInt(U32(sym & 0xFFFFFFFFu));
    writeInt(U32(sym >> 32));
  }

  void done() {
    U32 init_base = base;
    if (length > 2 * AC_MIN_LENGTH) {
      base += AC_MIN_LENGTH;
      length = AC_MIN_LENGTH >> 1;
    } else {
      base += AC_MIN_LENGTH >> 1;
      length = AC_MIN_LENGTH >> 9;
    }
    if (init_base > base) propagate_carry();
    renorm();
    // the decoder reads 4 init bytes; pad so they exist
    out.push_back(0);
    out.push_back(0);
    out.push_back(0);
  }
};

// ---------------------------------------------------- integer compressor ----

struct IntegerModelSet {
  std::vector<ArithmeticModel> mBits;       // one per context
  ArithmeticBitModel mCorrector0;
  std::vector<ArithmeticModel> mCorrector;  // 1..corr_bits
};

struct IntegerCodec {
  U32 bits, contexts, bits_high;
  U32 corr_bits, corr_range;
  I32 corr_min, corr_max;
  U32 k = 0;
  IntegerModelSet m;

  void setup(U32 bits_, U32 contexts_, U32 bits_high_ = 8) {
    bits = bits_;
    contexts = contexts_;
    bits_high = bits_high_;
    if (bits && bits < 32) {
      corr_bits = bits;
      corr_range = 1u << bits;
      corr_min = -I32(corr_range / 2);
      corr_max = corr_min + I32(corr_range) - 1;
    } else {
      corr_bits = 32;
      corr_range = 0;
      corr_min = INT32_MIN;
      corr_max = INT32_MAX;
    }
  }

  void initModels(bool for_compress) {
    m.mBits.resize(contexts);
    for (U32 c = 0; c < contexts; c++) m.mBits[c].init(corr_bits + 1, for_compress);
    m.mCorrector0.init();
    m.mCorrector.resize(corr_bits + 1);
    for (U32 i = 1; i <= corr_bits; i++)
      m.mCorrector[i].init(i <= bits_high ? (1u << i) : (1u << bits_high),
                           for_compress);
  }

  I32 readCorrector(Decoder& dec, ArithmeticModel& mb) {
    I32 c;
    k = dec.decodeSymbol(mb);
    if (k) {
      if (k < 32) {
        if (k <= bits_high) {
          c = I32(dec.decodeSymbol(m.mCorrector[k]));
        } else {
          U32 k1 = k - bits_high;
          c = I32(dec.decodeSymbol(m.mCorrector[k]));
          U32 c1 = (k1 <= 19) ? dec.readBits(k1)
                              : ((dec.readBits(16)) | (dec.readBits(k1 - 16) << 16));
          c = (c << k1) | I32(c1);
        }
        if (c >= (1 << (k - 1))) c += 1;
        else c -= ((1 << k) - 1);
      } else {
        c = corr_min;
      }
    } else {
      c = I32(dec.decodeBit(m.mCorrector0));
    }
    return c;
  }

  I32 decompress(Decoder& dec, I32 pred, U32 context) {
    I32 real = pred + readCorrector(dec, m.mBits[context]);
    if (corr_range) {
      if (real < 0) real += I32(corr_range);
      else if (U32(real) >= corr_range) real -= I32(corr_range);
    }
    return real;
  }

  void writeCorrector(Encoder& enc, I32 c, ArithmeticModel& mb) {
    U32 c1;
    k = 0;
    c1 = (c <= 0) ? U32(-I64(c)) : U32(c - 1);
    while (c1) {
      c1 >>= 1;
      ++k;
    }
    enc.encodeSymbol(mb, k);
    if (k) {
      if (k < 32) {
        if (c >= 0) c -= 1;
        else c += ((1 << k) - 1);
        if (k <= bits_high) {
          enc.encodeSymbol(m.mCorrector[k], U32(c));
        } else {
          U32 k1 = k - bits_high;
          enc.encodeSymbol(m.mCorrector[k], U32(c) >> k1);
          U32 rest = U32(c) & ((1u << k1) - 1);
          if (k1 <= 19) enc.writeBits(k1, rest);
          else {
            enc.writeBits(16, rest & 0xFFFF);
            enc.writeBits(k1 - 16, rest >> 16);
          }
        }
      }
    } else {
      enc.encodeBit(m.mCorrector0, U32(c));
    }
  }

  void compress(Encoder& enc, I32 pred, I32 real, U32 context) {
    I32 corr = I32(U32(real) - U32(pred));
    if (corr_range) {
      if (corr < corr_min) corr += I32(corr_range);
      else if (corr > corr_max) corr -= I32(corr_range);
    }
    writeCorrector(enc, corr, m.mBits[context]);
  }
};

// ------------------------------------------------------- streaming median ----

struct StreamingMedian5 {
  I32 values[5];
  bool high;

  void init() {
    values[0] = values[1] = values[2] = values[3] = values[4] = 0;
    high = true;
  }

  void add(I32 v) {
    if (high) {
      if (v < values[2]) {
        values[4] = values[3];
        values[3] = values[2];
        if (v < values[0]) {
          values[2] = values[1];
          values[1] = values[0];
          values[0] = v;
        } else if (v < values[1]) {
          values[2] = values[1];
          values[1] = v;
        } else {
          values[2] = v;
        }
      } else {
        if (v < values[3]) {
          values[4] = values[3];
          values[3] = v;
        } else {
          values[4] = v;
        }
        high = false;
      }
    } else {
      if (values[2] < v) {
        values[0] = values[1];
        values[1] = values[2];
        if (values[4] < v) {
          values[2] = values[3];
          values[3] = values[4];
          values[4] = v;
        } else if (values[3] < v) {
          values[2] = values[3];
          values[3] = v;
        } else {
          values[2] = v;
        }
      } else {
        if (values[1] < v) {
          values[0] = values[1];
          values[1] = v;
        } else {
          values[0] = v;
        }
        high = true;
      }
    }
  }

  I32 get() const { return values[2]; }
};

// ----------------------------------------------------------- POINT10 v2 ----

static const U8 number_return_map[8][8] = {
    {15, 14, 13, 12, 11, 10, 9, 8}, {14, 0, 1, 3, 6, 10, 10, 9},
    {13, 1, 2, 4, 7, 11, 11, 10},   {12, 3, 4, 5, 8, 12, 12, 11},
    {11, 6, 7, 8, 9, 13, 13, 12},   {10, 10, 11, 12, 13, 14, 14, 13},
    {9, 10, 11, 12, 13, 14, 15, 14}, {8, 9, 10, 11, 12, 13, 14, 15}};

static const U8 number_return_level[8][8] = {
    {0, 1, 2, 3, 4, 5, 6, 7}, {1, 0, 1, 2, 3, 4, 5, 6},
    {2, 1, 0, 1, 2, 3, 4, 5}, {3, 2, 1, 0, 1, 2, 3, 4},
    {4, 3, 2, 1, 0, 1, 2, 3}, {5, 4, 3, 2, 1, 0, 1, 2},
    {6, 5, 4, 3, 2, 1, 0, 1}, {7, 6, 5, 4, 3, 2, 1, 0}};

static inline U8 u8_fold(I32 n) { return U8(n & 0xFF); }
static inline U8 u8_clamp(I32 n) {
  return n < 0 ? 0 : (n > 255 ? 255 : U8(n));
}

struct Point10v2 {
  bool for_compress;
  U8 last[20];
  U16 last_intensity[16];
  StreamingMedian5 last_x_diff_median5[16], last_y_diff_median5[16];
  I32 last_height[8];

  ArithmeticModel m_changed_values;
  IntegerCodec ic_intensity;
  ArithmeticModel m_scan_angle_rank[2];
  IntegerCodec ic_point_source_ID;
  std::vector<ArithmeticModel*> m_bit_byte, m_classification, m_user_data;
  IntegerCodec ic_dx, ic_dy, ic_z;

  ~Point10v2() {
    for (auto* p : m_bit_byte) delete p;
    for (auto* p : m_classification) delete p;
    for (auto* p : m_user_data) delete p;
  }

  void init(const U8* item, bool compress) {
    for_compress = compress;
    for (int i = 0; i < 16; i++) {
      last_x_diff_median5[i].init();
      last_y_diff_median5[i].init();
      last_intensity[i] = 0;
    }
    for (int i = 0; i < 8; i++) last_height[i] = 0;

    m_changed_values.init(64, compress);
    ic_intensity.setup(16, 4);
    ic_intensity.initModels(compress);
    m_scan_angle_rank[0].init(256, compress);
    m_scan_angle_rank[1].init(256, compress);
    ic_point_source_ID.setup(16, 1);
    ic_point_source_ID.initModels(compress);
    for (auto* p : m_bit_byte) delete p;
    for (auto* p : m_classification) delete p;
    for (auto* p : m_user_data) delete p;
    m_bit_byte.assign(256, nullptr);
    m_classification.assign(256, nullptr);
    m_user_data.assign(256, nullptr);
    ic_dx.setup(32, 2);
    ic_dx.initModels(compress);
    ic_dy.setup(32, 22);
    ic_dy.initModels(compress);
    ic_z.setup(32, 20);
    ic_z.initModels(compress);

    std::memcpy(last, item, 20);
    last[12] = 0;  // the reference implementation zeroes the intensity in
    last[13] = 0;  // last_item (prediction uses last_intensity[m] instead)
  }

  ArithmeticModel* lazyModel(std::vector<ArithmeticModel*>& v, U32 idx) {
    if (!v[idx]) {
      v[idx] = new ArithmeticModel();
      v[idx]->init(256, for_compress);
    }
    return v[idx];
  }

  void read(Decoder& dec, U8* item) {
    U32 r, n, m, l;
    U32 changed_values = dec.decodeSymbol(m_changed_values);
    if (changed_values) {
      if (changed_values & 32) {
        U8 b = U8(dec.decodeSymbol(*lazyModel(m_bit_byte, last[14])));
        last[14] = b;
      }
      r = last[14] & 7;
      n = (last[14] >> 3) & 7;
      m = number_return_map[n][r];
      l = number_return_level[n][r];
      if (changed_values & 16) {
        U16 intensity = U16(ic_intensity.decompress(
            dec, last_intensity[m], (m < 3 ? m : 3)));
        last_intensity[m] = intensity;
        std::memcpy(last + 12, &intensity, 2);
      } else {
        std::memcpy(last + 12, &last_intensity[m], 2);
      }
      if (changed_values & 8) {
        last[15] = U8(dec.decodeSymbol(*lazyModel(m_classification, last[15])));
      }
      if (changed_values & 4) {
        U32 f = (last[14] >> 6) & 1;
        U32 val = dec.decodeSymbol(m_scan_angle_rank[f]);
        last[16] = u8_fold(I32(val) + I32(last[16]));
      }
      if (changed_values & 2) {
        last[17] = U8(dec.decodeSymbol(*lazyModel(m_user_data, last[17])));
      }
      if (changed_values & 1) {
        U16 psid;
        std::memcpy(&psid, last + 18, 2);
        psid = U16(ic_point_source_ID.decompress(dec, psid, 0));
        std::memcpy(last + 18, &psid, 2);
      }
    } else {
      r = last[14] & 7;
      n = (last[14] >> 3) & 7;
      m = number_return_map[n][r];
      l = number_return_level[n][r];
      std::memcpy(last + 12, &last_intensity[m], 2);
    }

    // x
    I32 x, y, z;
    std::memcpy(&x, last + 0, 4);
    std::memcpy(&y, last + 4, 4);
    std::memcpy(&z, last + 8, 4);
    I32 median = last_x_diff_median5[m].get();
    I32 diff = ic_dx.decompress(dec, median, n == 1);
    x += diff;
    last_x_diff_median5[m].add(diff);
    // y
    median = last_y_diff_median5[m].get();
    U32 k_bits = ic_dx.k;
    diff = ic_dy.decompress(
        dec, median, (n == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20));
    y += diff;
    last_y_diff_median5[m].add(diff);
    // z
    k_bits = (ic_dx.k + ic_dy.k) / 2;
    z = ic_z.decompress(dec, last_height[l],
                        (n == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18));
    last_height[l] = z;

    std::memcpy(last + 0, &x, 4);
    std::memcpy(last + 4, &y, 4);
    std::memcpy(last + 8, &z, 4);
    std::memcpy(item, last, 20);
  }

  void write(Encoder& enc, const U8* item) {
    U32 r = item[14] & 7;
    U32 n = (item[14] >> 3) & 7;
    U32 m = number_return_map[n][r];
    U32 l = number_return_level[n][r];

    U16 intensity;
    std::memcpy(&intensity, item + 12, 2);
    U16 last_psid, psid;
    std::memcpy(&last_psid, last + 18, 2);
    std::memcpy(&psid, item + 18, 2);

    U32 changed_values =
        (U32(last[14] != item[14]) << 5) |
        (U32(last_intensity[m] != intensity) << 4) |
        (U32(last[15] != item[15]) << 3) | (U32(last[16] != item[16]) << 2) |
        (U32(last[17] != item[17]) << 1) | U32(last_psid != psid);
    enc.encodeSymbol(m_changed_values, changed_values);
    if (changed_values) {
      if (changed_values & 32)
        enc.encodeSymbol(*lazyModel(m_bit_byte, last[14]), item[14]);
      if (changed_values & 16) {
        ic_intensity.compress(enc, last_intensity[m], intensity,
                              (m < 3 ? m : 3));
        last_intensity[m] = intensity;
      }
      if (changed_values & 8)
        enc.encodeSymbol(*lazyModel(m_classification, last[15]), item[15]);
      if (changed_values & 4) {
        U32 f = (item[14] >> 6) & 1;
        enc.encodeSymbol(m_scan_angle_rank[f],
                         u8_fold(I32(item[16]) - I32(last[16])));
      }
      if (changed_values & 2)
        enc.encodeSymbol(*lazyModel(m_user_data, last[17]), item[17]);
      if (changed_values & 1)
        ic_point_source_ID.compress(enc, last_psid, psid, 0);
    }

    I32 x, y, z, lx, ly, lz;
    std::memcpy(&x, item + 0, 4);
    std::memcpy(&y, item + 4, 4);
    std::memcpy(&z, item + 8, 4);
    std::memcpy(&lx, last + 0, 4);
    std::memcpy(&ly, last + 4, 4);
    std::memcpy(&lz, last + 8, 4);

    I32 median = last_x_diff_median5[m].get();
    I32 diff = I32(U32(x) - U32(lx));
    ic_dx.compress(enc, median, diff, n == 1);
    last_x_diff_median5[m].add(diff);

    median = last_y_diff_median5[m].get();
    U32 k_bits = ic_dx.k;
    diff = I32(U32(y) - U32(ly));
    ic_dy.compress(enc, median, diff,
                   (n == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20));
    last_y_diff_median5[m].add(diff);

    k_bits = (ic_dx.k + ic_dy.k) / 2;
    ic_z.compress(enc, last_height[l], z,
                  (n == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18));
    last_height[l] = z;

    std::memcpy(last, item, 20);
    last[12] = 0;
    last[13] = 0;
  }
};

// ---------------------------------------------------------- GPSTIME11 v2 ----

constexpr I32 GPS_MULTI = 500;
constexpr I32 GPS_MULTI_MINUS = -10;
constexpr U32 GPS_MULTI_UNCHANGED = U32(GPS_MULTI - GPS_MULTI_MINUS + 1);  // 511
constexpr U32 GPS_MULTI_CODE_FULL = GPS_MULTI_UNCHANGED + 1;               // 512
constexpr U32 GPS_MULTI_TOTAL = U32(GPS_MULTI - GPS_MULTI_MINUS + 6);      // 516

union I64F64 {
  I64 i64;
  U64 u64;
  double f64;
};

struct Gpstime11v2 {
  U32 last_idx, next_idx;
  I64F64 last_gpstime[4];
  I32 last_gpstime_diff[4];
  I32 multi_extreme_counter[4];
  ArithmeticModel m_gpstime_multi, m_gpstime_0diff;
  IntegerCodec ic_gpstime;

  void init(const U8* item, bool compress) {
    m_gpstime_multi.init(GPS_MULTI_TOTAL, compress);
    m_gpstime_0diff.init(6, compress);
    ic_gpstime.setup(32, 9);
    ic_gpstime.initModels(compress);
    last_idx = 0;
    next_idx = 0;
    for (int i = 0; i < 4; i++) {
      last_gpstime[i].u64 = 0;
      last_gpstime_diff[i] = 0;
      multi_extreme_counter[i] = 0;
    }
    std::memcpy(&last_gpstime[0].u64, item, 8);
  }

  void read(Decoder& dec, U8* item) {
    if (last_gpstime_diff[last_idx] == 0) {
      U32 multi = dec.decodeSymbol(m_gpstime_0diff);
      if (multi == 1) {
        last_gpstime_diff[last_idx] = ic_gpstime.decompress(dec, 0, 0);
        last_gpstime[last_idx].i64 += last_gpstime_diff[last_idx];
        multi_extreme_counter[last_idx] = 0;
      } else if (multi == 2) {
        next_idx = (next_idx + 1) & 3;
        U64 hi = U64(U32(ic_gpstime.decompress(
            dec, I32(last_gpstime[last_idx].u64 >> 32), 8)));
        last_gpstime[next_idx].u64 = (hi << 32) | U64(dec.readInt());
        last_idx = next_idx;
        last_gpstime_diff[last_idx] = 0;
        multi_extreme_counter[last_idx] = 0;
      } else if (multi > 2) {
        last_idx = (last_idx + multi - 2) & 3;
        read(dec, item);
        return;
      }
    } else {
      U32 multi = dec.decodeSymbol(m_gpstime_multi);
      if (multi == 1) {
        last_gpstime[last_idx].i64 +=
            ic_gpstime.decompress(dec, last_gpstime_diff[last_idx], 1);
        multi_extreme_counter[last_idx] = 0;
      } else if (multi < GPS_MULTI_UNCHANGED) {
        I32 gpstime_diff;
        if (multi == 0) {
          gpstime_diff = ic_gpstime.decompress(dec, 0, 7);
          multi_extreme_counter[last_idx]++;
          if (multi_extreme_counter[last_idx] > 3) {
            last_gpstime_diff[last_idx] = gpstime_diff;
            multi_extreme_counter[last_idx] = 0;
          }
        } else if (multi < U32(GPS_MULTI)) {
          if (multi < 10)
            gpstime_diff = ic_gpstime.decompress(
                dec, I32(multi) * last_gpstime_diff[last_idx], 2);
          else
            gpstime_diff = ic_gpstime.decompress(
                dec, I32(multi) * last_gpstime_diff[last_idx], 3);
        } else if (multi == U32(GPS_MULTI)) {
          gpstime_diff = ic_gpstime.decompress(
              dec, GPS_MULTI * last_gpstime_diff[last_idx], 4);
          multi_extreme_counter[last_idx]++;
          if (multi_extreme_counter[last_idx] > 3) {
            last_gpstime_diff[last_idx] = gpstime_diff;
            multi_extreme_counter[last_idx] = 0;
          }
        } else {
          I32 neg_multi = GPS_MULTI - I32(multi);
          if (neg_multi > GPS_MULTI_MINUS) {
            gpstime_diff = ic_gpstime.decompress(
                dec, neg_multi * last_gpstime_diff[last_idx], 5);
          } else {
            gpstime_diff = ic_gpstime.decompress(
                dec, GPS_MULTI_MINUS * last_gpstime_diff[last_idx], 6);
            multi_extreme_counter[last_idx]++;
            if (multi_extreme_counter[last_idx] > 3) {
              last_gpstime_diff[last_idx] = gpstime_diff;
              multi_extreme_counter[last_idx] = 0;
            }
          }
        }
        last_gpstime[last_idx].i64 += gpstime_diff;
      } else if (multi == GPS_MULTI_CODE_FULL) {
        next_idx = (next_idx + 1) & 3;
        U64 hi = U64(U32(ic_gpstime.decompress(
            dec, I32(last_gpstime[last_idx].u64 >> 32), 8)));
        last_gpstime[next_idx].u64 = (hi << 32) | U64(dec.readInt());
        last_idx = next_idx;
        last_gpstime_diff[last_idx] = 0;
        multi_extreme_counter[last_idx] = 0;
      } else if (multi >= GPS_MULTI_CODE_FULL) {
        last_idx = (last_idx + multi - GPS_MULTI_CODE_FULL) & 3;
        read(dec, item);
        return;
      }
    }
    std::memcpy(item, &last_gpstime[last_idx].u64, 8);
  }

  void write(Encoder& enc, const U8* item) {
    I64F64 this_gpstime;
    std::memcpy(&this_gpstime.u64, item, 8);

    if (last_gpstime_diff[last_idx] == 0) {
      if (this_gpstime.i64 == last_gpstime[last_idx].i64) {
        enc.encodeSymbol(m_gpstime_0diff, 0);
        return;
      }
      // look whether another sequence matches
      for (U32 i = 1; i < 4; i++) {
        I64 other_diff_64 = this_gpstime.i64 - last_gpstime[(last_idx + i) & 3].i64;
        if (other_diff_64 == I64(I32(other_diff_64)) &&
            last_gpstime[(last_idx + i) & 3].u64 != 0) {
          // only switch when the other sequence gives a 32-bit diff and the
          // current one cannot
          I64 curr_diff_64 = this_gpstime.i64 - last_gpstime[last_idx].i64;
          if (curr_diff_64 != I64(I32(curr_diff_64))) {
            enc.encodeSymbol(m_gpstime_0diff, i + 2);
            last_idx = (last_idx + i) & 3;
            write(enc, item);
            return;
          }
        }
      }
      I64 curr_diff_64 = this_gpstime.i64 - last_gpstime[last_idx].i64;
      I32 curr_diff = I32(curr_diff_64);
      if (curr_diff_64 == I64(curr_diff)) {
        enc.encodeSymbol(m_gpstime_0diff, 1);
        ic_gpstime.compress(enc, 0, curr_diff, 0);
        last_gpstime_diff[last_idx] = curr_diff;
        multi_extreme_counter[last_idx] = 0;
        last_gpstime[last_idx].i64 = this_gpstime.i64;
      } else {
        enc.encodeSymbol(m_gpstime_0diff, 2);
        ic_gpstime.compress(enc, I32(last_gpstime[last_idx].u64 >> 32),
                            I32(this_gpstime.u64 >> 32), 8);
        enc.writeInt(U32(this_gpstime.u64));
        next_idx = (next_idx + 1) & 3;
        last_idx = next_idx;
        last_gpstime[last_idx].i64 = this_gpstime.i64;
        last_gpstime_diff[last_idx] = 0;
        multi_extreme_counter[last_idx] = 0;
      }
    } else {
      if (this_gpstime.i64 == last_gpstime[last_idx].i64) {
        enc.encodeSymbol(m_gpstime_multi, GPS_MULTI_UNCHANGED);
        return;
      }
      I64 curr_diff_64 = this_gpstime.i64 - last_gpstime[last_idx].i64;
      I32 curr_diff = I32(curr_diff_64);
      if (curr_diff_64 == I64(curr_diff)) {
        float multi_f =
            float(curr_diff) / float(last_gpstime_diff[last_idx]);
        I32 multi = multi_f >= 0 ? I32(multi_f + 0.5f) : I32(multi_f - 0.5f);
        if (multi == 1) {
          enc.encodeSymbol(m_gpstime_multi, 1);
          ic_gpstime.compress(enc, last_gpstime_diff[last_idx], curr_diff, 1);
          multi_extreme_counter[last_idx] = 0;
        } else if (multi > 0) {
          if (multi < GPS_MULTI) {
            enc.encodeSymbol(m_gpstime_multi, U32(multi));
            if (multi < 10)
              ic_gpstime.compress(enc, multi * last_gpstime_diff[last_idx],
                                  curr_diff, 2);
            else
              ic_gpstime.compress(enc, multi * last_gpstime_diff[last_idx],
                                  curr_diff, 3);
          } else {
            enc.encodeSymbol(m_gpstime_multi, U32(GPS_MULTI));
            ic_gpstime.compress(enc, GPS_MULTI * last_gpstime_diff[last_idx],
                                curr_diff, 4);
            multi_extreme_counter[last_idx]++;
            if (multi_extreme_counter[last_idx] > 3) {
              last_gpstime_diff[last_idx] = curr_diff;
              multi_extreme_counter[last_idx] = 0;
            }
          }
        } else if (multi < 0) {
          if (multi > GPS_MULTI_MINUS) {
            enc.encodeSymbol(m_gpstime_multi, U32(GPS_MULTI - multi));
            ic_gpstime.compress(enc, multi * last_gpstime_diff[last_idx],
                                curr_diff, 5);
          } else {
            enc.encodeSymbol(m_gpstime_multi,
                             U32(GPS_MULTI - GPS_MULTI_MINUS));
            ic_gpstime.compress(enc,
                                GPS_MULTI_MINUS * last_gpstime_diff[last_idx],
                                curr_diff, 6);
            multi_extreme_counter[last_idx]++;
            if (multi_extreme_counter[last_idx] > 3) {
              last_gpstime_diff[last_idx] = curr_diff;
              multi_extreme_counter[last_idx] = 0;
            }
          }
        } else {
          enc.encodeSymbol(m_gpstime_multi, 0);
          ic_gpstime.compress(enc, 0, curr_diff, 7);
          multi_extreme_counter[last_idx]++;
          if (multi_extreme_counter[last_idx] > 3) {
            last_gpstime_diff[last_idx] = curr_diff;
            multi_extreme_counter[last_idx] = 0;
          }
        }
        last_gpstime[last_idx].i64 = this_gpstime.i64;
      } else {
        // cannot represent as 32-bit diff: switch or full
        for (U32 i = 1; i < 4; i++) {
          I64 other_diff_64 =
              this_gpstime.i64 - last_gpstime[(last_idx + i) & 3].i64;
          if (other_diff_64 == I64(I32(other_diff_64))) {
            enc.encodeSymbol(m_gpstime_multi, GPS_MULTI_CODE_FULL + i);
            last_idx = (last_idx + i) & 3;
            write(enc, item);
            return;
          }
        }
        enc.encodeSymbol(m_gpstime_multi, GPS_MULTI_CODE_FULL);
        ic_gpstime.compress(enc, I32(last_gpstime[last_idx].u64 >> 32),
                            I32(this_gpstime.u64 >> 32), 8);
        enc.writeInt(U32(this_gpstime.u64));
        next_idx = (next_idx + 1) & 3;
        last_idx = next_idx;
        last_gpstime[last_idx].i64 = this_gpstime.i64;
        last_gpstime_diff[last_idx] = 0;
        multi_extreme_counter[last_idx] = 0;
      }
    }
  }
};

// -------------------------------------------------------------- RGB12 v2 ----

struct Rgb12v2 {
  U16 last[3];
  ArithmeticModel m_byte_used;
  ArithmeticModel m_rgb_diff[6];

  void init(const U8* item, bool compress) {
    m_byte_used.init(128, compress);
    for (int i = 0; i < 6; i++) m_rgb_diff[i].init(256, compress);
    std::memcpy(last, item, 6);
  }

  void read(Decoder& dec, U8* item) {
    U16 r, g, b;
    I32 diff;
    U32 corr;
    U32 sym = dec.decodeSymbol(m_byte_used);
    if (sym & 1) {
      corr = dec.decodeSymbol(m_rgb_diff[0]);
      r = U16(u8_fold(I32(corr) + (last[0] & 0xFF)));
    } else {
      r = last[0] & 0xFF;
    }
    if (sym & 2) {
      corr = dec.decodeSymbol(m_rgb_diff[1]);
      r |= U16(u8_fold(I32(corr) + (last[0] >> 8))) << 8;
    } else {
      r |= last[0] & 0xFF00;
    }
    if (sym & 64) {
      diff = (r & 0xFF) - (last[0] & 0xFF);
      if (sym & 4) {
        corr = dec.decodeSymbol(m_rgb_diff[2]);
        g = U16(u8_fold(I32(corr) + u8_clamp(diff + (last[1] & 0xFF))));
      } else {
        g = last[1] & 0xFF;
      }
      if (sym & 16) {
        corr = dec.decodeSymbol(m_rgb_diff[4]);
        diff = (diff + ((g & 0xFF) - (last[1] & 0xFF))) / 2;
        b = U16(u8_fold(I32(corr) + u8_clamp(diff + (last[2] & 0xFF))));
      } else {
        b = last[2] & 0xFF;
      }
      diff = (r >> 8) - (last[0] >> 8);
      if (sym & 8) {
        corr = dec.decodeSymbol(m_rgb_diff[3]);
        g |= U16(u8_fold(I32(corr) + u8_clamp(diff + (last[1] >> 8)))) << 8;
      } else {
        g |= last[1] & 0xFF00;
      }
      if (sym & 32) {
        corr = dec.decodeSymbol(m_rgb_diff[5]);
        diff = (diff + ((g >> 8) - (last[1] >> 8))) / 2;
        b |= U16(u8_fold(I32(corr) + u8_clamp(diff + (last[2] >> 8)))) << 8;
      } else {
        b |= last[2] & 0xFF00;
      }
    } else {
      g = r;
      b = r;
    }
    last[0] = r;
    last[1] = g;
    last[2] = b;
    std::memcpy(item, last, 6);
  }

  void write(Encoder& enc, const U8* item) {
    U16 r, g, b;
    std::memcpy(&r, item + 0, 2);
    std::memcpy(&g, item + 2, 2);
    std::memcpy(&b, item + 4, 2);

    U32 sym = 0;
    bool rl = (r & 0xFF) != (last[0] & 0xFF);
    bool rh = (r >> 8) != (last[0] >> 8);
    if (rl) sym |= 1;
    if (rh) sym |= 2;
    bool gb_differ = ((r & 0xFF) != (g & 0xFF)) || ((r & 0xFF) != (b & 0xFF)) ||
                     ((r >> 8) != (g >> 8)) || ((r >> 8) != (b >> 8));
    if (gb_differ) {
      sym |= 64;
      if ((g & 0xFF) != (last[1] & 0xFF)) sym |= 4;
      if ((g >> 8) != (last[1] >> 8)) sym |= 8;
      if ((b & 0xFF) != (last[2] & 0xFF)) sym |= 16;
      if ((b >> 8) != (last[2] >> 8)) sym |= 32;
    }
    enc.encodeSymbol(m_byte_used, sym);

    I32 diff;
    if (sym & 1)
      enc.encodeSymbol(m_rgb_diff[0],
                       u8_fold(I32(r & 0xFF) - I32(last[0] & 0xFF)));
    if (sym & 2)
      enc.encodeSymbol(m_rgb_diff[1], u8_fold(I32(r >> 8) - I32(last[0] >> 8)));
    if (sym & 64) {
      diff = (r & 0xFF) - (last[0] & 0xFF);
      if (sym & 4)
        enc.encodeSymbol(
            m_rgb_diff[2],
            u8_fold(I32(g & 0xFF) - u8_clamp(diff + (last[1] & 0xFF))));
      if (sym & 16) {
        diff = (diff + ((g & 0xFF) - (last[1] & 0xFF))) / 2;
        enc.encodeSymbol(
            m_rgb_diff[4],
            u8_fold(I32(b & 0xFF) - u8_clamp(diff + (last[2] & 0xFF))));
      }
      diff = (r >> 8) - (last[0] >> 8);
      if (sym & 8)
        enc.encodeSymbol(m_rgb_diff[3],
                         u8_fold(I32(g >> 8) - u8_clamp(diff + (last[1] >> 8))));
      if (sym & 32) {
        diff = (diff + ((g >> 8) - (last[1] >> 8))) / 2;
        enc.encodeSymbol(m_rgb_diff[5],
                         u8_fold(I32(b >> 8) - u8_clamp(diff + (last[2] >> 8))));
      }
    }
    last[0] = r;
    last[1] = g;
    last[2] = b;
  }
};

// ------------------------------------------------------- WAVEPACKET13 v1 ----

struct Wavepacket13v1 {
  U8 last[29];  // 28-byte packed wavepacket after the leading index byte
  I32 last_diff_32;
  U32 sym_last_offset_diff;
  ArithmeticModel m_packet_index;
  ArithmeticModel m_offset_diff[4];
  IntegerCodec ic_offset_diff, ic_packet_size, ic_return_point, ic_xyz;

  void init(const U8* item, bool compress) {
    m_packet_index.init(256, compress);
    for (int i = 0; i < 4; i++) m_offset_diff[i].init(4, compress);
    ic_offset_diff.setup(32, 1);
    ic_offset_diff.initModels(compress);
    ic_packet_size.setup(32, 1);
    ic_packet_size.initModels(compress);
    ic_return_point.setup(32, 1);
    ic_return_point.initModels(compress);
    ic_xyz.setup(32, 3);
    ic_xyz.initModels(compress);
    last_diff_32 = 0;
    sym_last_offset_diff = 0;
    std::memcpy(last, item, 29);
  }

  void read(Decoder& dec, U8* item) {
    item[0] = U8(dec.decodeSymbol(m_packet_index));

    U64 last_offset, offset;
    U32 last_size, size;
    I32 last_rp, rp, lx, ly, lz;
    std::memcpy(&last_offset, last + 1, 8);
    std::memcpy(&last_size, last + 9, 4);
    std::memcpy(&last_rp, last + 13, 4);
    std::memcpy(&lx, last + 17, 4);
    std::memcpy(&ly, last + 21, 4);
    std::memcpy(&lz, last + 25, 4);

    sym_last_offset_diff = dec.decodeSymbol(m_offset_diff[sym_last_offset_diff]);
    if (sym_last_offset_diff == 0) {
      offset = last_offset;
    } else if (sym_last_offset_diff == 1) {
      offset = last_offset + last_size;
    } else if (sym_last_offset_diff == 2) {
      last_diff_32 = ic_offset_diff.decompress(dec, last_diff_32, 0);
      offset = U64(I64(last_offset) + last_diff_32);
    } else {
      offset = dec.readInt64();
    }
    size = U32(ic_packet_size.decompress(dec, I32(last_size), 0));
    rp = ic_return_point.decompress(dec, last_rp, 0);
    I32 x = ic_xyz.decompress(dec, lx, 0);
    I32 y = ic_xyz.decompress(dec, ly, 1);
    I32 z = ic_xyz.decompress(dec, lz, 2);

    std::memcpy(item + 1, &offset, 8);
    std::memcpy(item + 9, &size, 4);
    std::memcpy(item + 13, &rp, 4);
    std::memcpy(item + 17, &x, 4);
    std::memcpy(item + 21, &y, 4);
    std::memcpy(item + 25, &z, 4);
    std::memcpy(last, item, 29);
  }

  void write(Encoder& enc, const U8* item) {
    enc.encodeSymbol(m_packet_index, item[0]);

    U64 last_offset, offset;
    U32 last_size, size;
    I32 last_rp, rp, lx, ly, lz, x, y, z;
    std::memcpy(&last_offset, last + 1, 8);
    std::memcpy(&last_size, last + 9, 4);
    std::memcpy(&last_rp, last + 13, 4);
    std::memcpy(&lx, last + 17, 4);
    std::memcpy(&ly, last + 21, 4);
    std::memcpy(&lz, last + 25, 4);
    std::memcpy(&offset, item + 1, 8);
    std::memcpy(&size, item + 9, 4);
    std::memcpy(&rp, item + 13, 4);
    std::memcpy(&x, item + 17, 4);
    std::memcpy(&y, item + 21, 4);
    std::memcpy(&z, item + 25, 4);

    if (offset == last_offset) {
      enc.encodeSymbol(m_offset_diff[sym_last_offset_diff], 0);
      sym_last_offset_diff = 0;
    } else if (offset == last_offset + last_size) {
      enc.encodeSymbol(m_offset_diff[sym_last_offset_diff], 1);
      sym_last_offset_diff = 1;
    } else {
      I64 diff64 = I64(offset) - I64(last_offset);
      if (diff64 == I64(I32(diff64))) {
        enc.encodeSymbol(m_offset_diff[sym_last_offset_diff], 2);
        sym_last_offset_diff = 2;
        ic_offset_diff.compress(enc, last_diff_32, I32(diff64), 0);
        last_diff_32 = I32(diff64);
      } else {
        enc.encodeSymbol(m_offset_diff[sym_last_offset_diff], 3);
        sym_last_offset_diff = 3;
        enc.writeInt64(offset);
      }
    }
    ic_packet_size.compress(enc, I32(last_size), I32(size), 0);
    ic_return_point.compress(enc, last_rp, rp, 0);
    ic_xyz.compress(enc, lx, x, 0);
    ic_xyz.compress(enc, ly, y, 1);
    ic_xyz.compress(enc, lz, z, 2);
    std::memcpy(last, item, 29);
  }
};

// --------------------------------------------------------------- BYTE v2 ----

struct Bytev2 {
  U32 number;
  std::vector<U8> last;
  std::vector<ArithmeticModel> m_byte;

  void init(const U8* item, U32 n, bool compress) {
    number = n;
    m_byte.resize(n);
    for (U32 i = 0; i < n; i++) m_byte[i].init(256, compress);
    last.assign(item, item + n);
  }

  void read(Decoder& dec, U8* item) {
    for (U32 i = 0; i < number; i++) {
      item[i] = u8_fold(I32(dec.decodeSymbol(m_byte[i])) + I32(last[i]));
    }
    std::memcpy(last.data(), item, number);
  }

  void write(Encoder& enc, const U8* item) {
    for (U32 i = 0; i < number; i++) {
      enc.encodeSymbol(m_byte[i], u8_fold(I32(item[i]) - I32(last[i])));
    }
    std::memcpy(last.data(), item, number);
  }
};

// =================================================================== v3 =====
// LASzip "native LAS 1.4 extension" layered compression (compressor 3):
// item codecs POINT14 v3, RGB14 v3, RGBNIR14 v3, BYTE14 v3.  Each chunk is
// [raw first point][u32 count][u32 layer sizes...][layer byte blocks...],
// with an independent range coder per layer (verified against the
// reference fixtures 10_points_format_{6,7,8}.laz; the reference itself
// reads these through the laz crate, raw_readers.rs:418-660, and rejects
// only formats 9/10, raw_readers.rs:451-455).

// (number_of_returns, return_number) -> context tables of the published
// LASzip laspoint14 scheme.  The 6-context map is the symmetric banded
// merge of the v2 8x8 map onto 6 context groups; the 8-level table is
// clamp(|n - r|, 0, 7).  PROVENANCE CAVEAT: this is a STRUCTURAL
// reconstruction of laszip's number_return_map_6ctx /
// number_return_level_8ctx (src/lasreaditemcompressed_v3.cpp) — the
// 10-point reference fixtures decode table-INVARIANTLY (see
// tests/test_laz_tables.py census), so they cannot confirm any entry.
// Encoder/decoder self-consistency over every entry IS tested
// (full-coverage synthetic archive); laz_set_point14_tables() injects
// the authoritative arrays without a rebuild when retrievable.
static U8 number_return_map_6ctx[16][16] = {
    {0, 1, 2, 3, 4, 5, 3, 4, 4, 5, 5, 5, 5, 5, 5, 5},
    {1, 0, 1, 3, 4, 5, 3, 4, 4, 5, 5, 5, 5, 5, 5, 5},
    {2, 1, 0, 1, 3, 4, 3, 3, 4, 4, 4, 5, 5, 5, 5, 5},
    {3, 3, 1, 0, 1, 3, 2, 3, 3, 4, 4, 4, 5, 5, 5, 5},
    {4, 4, 3, 1, 0, 1, 2, 2, 3, 3, 4, 4, 4, 5, 5, 5},
    {5, 5, 4, 3, 1, 0, 1, 2, 2, 3, 3, 4, 4, 4, 5, 5},
    {3, 3, 3, 2, 2, 1, 0, 1, 2, 2, 3, 3, 4, 4, 4, 5},
    {4, 4, 3, 3, 2, 2, 1, 0, 1, 2, 2, 3, 3, 4, 4, 4},
    {4, 4, 4, 3, 3, 2, 2, 1, 0, 1, 2, 2, 3, 3, 4, 4},
    {5, 5, 4, 4, 3, 3, 2, 2, 1, 0, 1, 2, 2, 3, 3, 4},
    {5, 5, 4, 4, 4, 3, 3, 2, 2, 1, 0, 1, 2, 2, 3, 3},
    {5, 5, 5, 4, 4, 4, 3, 3, 2, 2, 1, 0, 1, 2, 2, 3},
    {5, 5, 5, 5, 4, 4, 4, 3, 3, 2, 2, 1, 0, 1, 2, 2},
    {5, 5, 5, 5, 5, 4, 4, 4, 3, 3, 2, 2, 1, 0, 1, 2},
    {5, 5, 5, 5, 5, 5, 4, 4, 4, 3, 3, 2, 2, 1, 0, 1},
    {5, 5, 5, 5, 5, 5, 5, 4, 4, 4, 3, 3, 2, 2, 1, 0}};

static U8 number_return_level_8ctx[16][16];
static bool level_8ctx_initialized = false;
static void init_level_8ctx() {
  if (level_8ctx_initialized) return;
  for (int n = 0; n < 16; n++)
    for (int r = 0; r < 16; r++) {
      int d = n > r ? n - r : r - n;
      number_return_level_8ctx[n][r] = U8(d > 7 ? 7 : d);
    }
  level_8ctx_initialized = true;
}

// host mirror of the 30-byte LAS 1.4 point record (wire layout
// X/Y/Z i32, intensity u16, returns byte, flags byte, classification,
// user_data, scan_angle i16, point_source u16, gps_time f64)
struct LasPoint14 {
  I32 X, Y, Z;
  U16 intensity;
  U8 return_number, number_of_returns;
  U8 classification_flags, scanner_channel, scan_direction_flag,
      edge_of_flight_line;
  U8 classification, user_data;
  I16 scan_angle;
  U16 point_source_ID;
  I64F64 gps_time;
  bool gps_time_change;
};

static void unpack14(const U8* w, LasPoint14& p) {
  std::memcpy(&p.X, w + 0, 4);
  std::memcpy(&p.Y, w + 4, 4);
  std::memcpy(&p.Z, w + 8, 4);
  std::memcpy(&p.intensity, w + 12, 2);
  p.return_number = w[14] & 0x0F;
  p.number_of_returns = w[14] >> 4;
  p.classification_flags = w[15] & 0x0F;
  p.scanner_channel = (w[15] >> 4) & 3;
  p.scan_direction_flag = (w[15] >> 6) & 1;
  p.edge_of_flight_line = (w[15] >> 7) & 1;
  p.classification = w[16];
  p.user_data = w[17];
  std::memcpy(&p.scan_angle, w + 18, 2);
  std::memcpy(&p.point_source_ID, w + 20, 2);
  std::memcpy(&p.gps_time.u64, w + 22, 8);
  p.gps_time_change = false;
}

static void pack14(const LasPoint14& p, U8* w) {
  std::memcpy(w + 0, &p.X, 4);
  std::memcpy(w + 4, &p.Y, 4);
  std::memcpy(w + 8, &p.Z, 4);
  std::memcpy(w + 12, &p.intensity, 2);
  w[14] = U8((p.return_number & 0x0F) | (p.number_of_returns << 4));
  w[15] = U8((p.classification_flags & 0x0F) | ((p.scanner_channel & 3) << 4) |
             ((p.scan_direction_flag & 1) << 6) |
             ((p.edge_of_flight_line & 1) << 7));
  w[16] = p.classification;
  w[17] = p.user_data;
  std::memcpy(w + 18, &p.scan_angle, 2);
  std::memcpy(w + 20, &p.point_source_ID, 2);
  std::memcpy(w + 22, &p.gps_time.u64, 8);
}

// POINT14 layer indices (chunk_sizes order)
enum P14Layer {
  L_XY = 0, L_Z, L_CLS, L_FLG, L_INT, L_SCA, L_UD, L_PS, L_GPS, P14_NLAYERS
};

struct Point14Ctx {
  bool unused;
  LasPoint14 last;
  U16 last_intensity[8];
  StreamingMedian5 last_X_diff_median5[12], last_Y_diff_median5[12];
  I32 last_Z[8];
  ArithmeticModel m_changed_values[8];  // 128 syms, ctx = last-point-return
  ArithmeticModel m_scanner_channel;    // 3 syms
  std::unique_ptr<ArithmeticModel> m_number_of_returns[16];  // lazy, 16 syms
  ArithmeticModel m_return_number_gps_same;                  // 13 syms
  std::unique_ptr<ArithmeticModel> m_return_number[16];      // lazy, 16 syms
  IntegerCodec ic_dX, ic_dY, ic_Z;
  std::unique_ptr<ArithmeticModel> m_classification[64];  // lazy, 256 syms
  std::unique_ptr<ArithmeticModel> m_flags[64];            // lazy, 64 syms
  std::unique_ptr<ArithmeticModel> m_user_data[64];        // lazy, 256 syms
  IntegerCodec ic_intensity, ic_scan_angle, ic_point_source_ID;
  ArithmeticModel m_gpstime_multi, m_gpstime_0diff;
  IntegerCodec ic_gpstime;
  U32 last_seq, next_seq;
  I64F64 last_gpstime[4];
  I32 last_gpstime_diff[4];
  I32 multi_extreme_counter[4];
};

struct Point14v3 {
  bool for_compress;
  Point14Ctx ctx[4];
  U32 cc;  // current context (scanner channel)
  Decoder dec[P14_NLAYERS];
  Encoder enc[P14_NLAYERS];
  bool changed[P14_NLAYERS];  // layer present (read) / value changed (write)

  void initContext(U32 c, const LasPoint14& seed) {
    bool fc = for_compress;
    Point14Ctx& x = ctx[c];
    for (int i = 0; i < 8; i++) x.m_changed_values[i].init(128, fc);
    x.m_scanner_channel.init(3, fc);
    for (int i = 0; i < 16; i++) {
      x.m_number_of_returns[i].reset();
      x.m_return_number[i].reset();
    }
    x.m_return_number_gps_same.init(13, fc);
    x.ic_dX.setup(32, 2);
    x.ic_dX.initModels(fc);
    x.ic_dY.setup(32, 22);
    x.ic_dY.initModels(fc);
    x.ic_Z.setup(32, 20);
    x.ic_Z.initModels(fc);
    for (int i = 0; i < 12; i++) {
      x.last_X_diff_median5[i].init();
      x.last_Y_diff_median5[i].init();
    }
    for (int i = 0; i < 8; i++) x.last_Z[i] = seed.Z;
    for (int i = 0; i < 64; i++) {
      x.m_classification[i].reset();
      x.m_flags[i].reset();
      x.m_user_data[i].reset();
    }
    x.ic_intensity.setup(16, 4);
    x.ic_intensity.initModels(fc);
    for (int i = 0; i < 8; i++) x.last_intensity[i] = seed.intensity;
    x.ic_scan_angle.setup(16, 2);
    x.ic_scan_angle.initModels(fc);
    x.ic_point_source_ID.setup(16, 1);
    x.ic_point_source_ID.initModels(fc);
    x.m_gpstime_multi.init(GPS_MULTI_TOTAL, fc);
    x.m_gpstime_0diff.init(5, fc);
    x.ic_gpstime.setup(32, 9);
    x.ic_gpstime.initModels(fc);
    x.last_seq = 0;
    x.next_seq = 0;
    for (int i = 0; i < 4; i++) {
      x.last_gpstime[i].u64 = 0;
      x.last_gpstime_diff[i] = 0;
      x.multi_extreme_counter[i] = 0;
    }
    x.last_gpstime[0] = seed.gps_time;
    x.last = seed;
    x.last.gps_time_change = false;
    x.unused = false;
  }

  ArithmeticModel* lazy(std::unique_ptr<ArithmeticModel>& slot, U32 nsyms) {
    if (!slot) {
      slot.reset(new ArithmeticModel());
      slot->init(nsyms, for_compress);
    }
    return slot.get();
  }

  // ---- gps time (v3 flavor of the GPSTIME11 scheme: no "unchanged" in
  //      the 0diff model since gps time is only coded when it changed) ----
  void readGpsTime(Point14Ctx& x) {
    if (x.last_gpstime_diff[x.last_seq] == 0) {
      U32 multi = dec[L_GPS].decodeSymbol(x.m_gpstime_0diff);
      if (multi == 0) {  // 32-bit diff
        x.last_gpstime_diff[x.last_seq] =
            x.ic_gpstime.decompress(dec[L_GPS], 0, 0);
        x.last_gpstime[x.last_seq].i64 += x.last_gpstime_diff[x.last_seq];
        x.multi_extreme_counter[x.last_seq] = 0;
      } else if (multi == 1) {  // full 64-bit
        x.next_seq = (x.next_seq + 1) & 3;
        U64 hi = U64(U32(x.ic_gpstime.decompress(
            dec[L_GPS], I32(x.last_gpstime[x.last_seq].u64 >> 32), 8)));
        x.last_gpstime[x.next_seq].u64 = (hi << 32) | U64(dec[L_GPS].readInt());
        x.last_seq = x.next_seq;
        x.last_gpstime_diff[x.last_seq] = 0;
        x.multi_extreme_counter[x.last_seq] = 0;
      } else {  // switch to another sequence
        x.last_seq = (x.last_seq + multi - 1) & 3;
        readGpsTime(x);
      }
    } else {
      U32 multi = dec[L_GPS].decodeSymbol(x.m_gpstime_multi);
      if (multi == 1) {
        x.last_gpstime[x.last_seq].i64 += x.ic_gpstime.decompress(
            dec[L_GPS], x.last_gpstime_diff[x.last_seq], 1);
        x.multi_extreme_counter[x.last_seq] = 0;
      } else if (multi < GPS_MULTI_UNCHANGED) {
        I32 gpstime_diff;
        if (multi == 0) {
          gpstime_diff = x.ic_gpstime.decompress(dec[L_GPS], 0, 7);
          x.multi_extreme_counter[x.last_seq]++;
          if (x.multi_extreme_counter[x.last_seq] > 3) {
            x.last_gpstime_diff[x.last_seq] = gpstime_diff;
            x.multi_extreme_counter[x.last_seq] = 0;
          }
        } else if (multi < U32(GPS_MULTI)) {
          if (multi < 10)
            gpstime_diff = x.ic_gpstime.decompress(
                dec[L_GPS], I32(multi) * x.last_gpstime_diff[x.last_seq], 2);
          else
            gpstime_diff = x.ic_gpstime.decompress(
                dec[L_GPS], I32(multi) * x.last_gpstime_diff[x.last_seq], 3);
        } else if (multi == U32(GPS_MULTI)) {
          gpstime_diff = x.ic_gpstime.decompress(
              dec[L_GPS], GPS_MULTI * x.last_gpstime_diff[x.last_seq], 4);
          x.multi_extreme_counter[x.last_seq]++;
          if (x.multi_extreme_counter[x.last_seq] > 3) {
            x.last_gpstime_diff[x.last_seq] = gpstime_diff;
            x.multi_extreme_counter[x.last_seq] = 0;
          }
        } else {
          I32 neg_multi = GPS_MULTI - I32(multi);
          if (neg_multi > GPS_MULTI_MINUS) {
            gpstime_diff = x.ic_gpstime.decompress(
                dec[L_GPS], neg_multi * x.last_gpstime_diff[x.last_seq], 5);
          } else {
            gpstime_diff = x.ic_gpstime.decompress(
                dec[L_GPS],
                GPS_MULTI_MINUS * x.last_gpstime_diff[x.last_seq], 6);
            x.multi_extreme_counter[x.last_seq]++;
            if (x.multi_extreme_counter[x.last_seq] > 3) {
              x.last_gpstime_diff[x.last_seq] = gpstime_diff;
              x.multi_extreme_counter[x.last_seq] = 0;
            }
          }
        }
        x.last_gpstime[x.last_seq].i64 += gpstime_diff;
      } else if (multi == GPS_MULTI_CODE_FULL) {
        x.next_seq = (x.next_seq + 1) & 3;
        U64 hi = U64(U32(x.ic_gpstime.decompress(
            dec[L_GPS], I32(x.last_gpstime[x.last_seq].u64 >> 32), 8)));
        x.last_gpstime[x.next_seq].u64 = (hi << 32) | U64(dec[L_GPS].readInt());
        x.last_seq = x.next_seq;
        x.last_gpstime_diff[x.last_seq] = 0;
        x.multi_extreme_counter[x.last_seq] = 0;
      } else {
        x.last_seq = (x.last_seq + multi - GPS_MULTI_CODE_FULL) & 3;
        readGpsTime(x);
      }
    }
  }

  void writeGpsTime(Point14Ctx& x, I64F64 t) {
    if (x.last_gpstime_diff[x.last_seq] == 0) {
      I64 curr_diff_64 = t.i64 - x.last_gpstime[x.last_seq].i64;
      I32 curr_diff = I32(curr_diff_64);
      if (curr_diff_64 == I64(curr_diff)) {
        enc[L_GPS].encodeSymbol(x.m_gpstime_0diff, 0);
        x.ic_gpstime.compress(enc[L_GPS], 0, curr_diff, 0);
        x.last_gpstime_diff[x.last_seq] = curr_diff;
        x.multi_extreme_counter[x.last_seq] = 0;
      } else {
        for (U32 i = 1; i < 4; i++) {
          I64 other = t.i64 - x.last_gpstime[(x.last_seq + i) & 3].i64;
          if (other == I64(I32(other))) {
            enc[L_GPS].encodeSymbol(x.m_gpstime_0diff, i + 1);
            x.last_seq = (x.last_seq + i) & 3;
            writeGpsTime(x, t);
            return;
          }
        }
        enc[L_GPS].encodeSymbol(x.m_gpstime_0diff, 1);
        x.ic_gpstime.compress(enc[L_GPS],
                              I32(x.last_gpstime[x.last_seq].u64 >> 32),
                              I32(t.u64 >> 32), 8);
        enc[L_GPS].writeInt(U32(t.u64));
        x.next_seq = (x.next_seq + 1) & 3;
        x.last_seq = x.next_seq;
        x.last_gpstime_diff[x.last_seq] = 0;
        x.multi_extreme_counter[x.last_seq] = 0;
      }
      x.last_gpstime[x.last_seq].i64 = t.i64;
    } else {
      I64 curr_diff_64 = t.i64 - x.last_gpstime[x.last_seq].i64;
      I32 curr_diff = I32(curr_diff_64);
      if (curr_diff_64 == I64(curr_diff)) {
        float multi_f =
            float(curr_diff) / float(x.last_gpstime_diff[x.last_seq]);
        I32 multi = multi_f >= 0 ? I32(multi_f + 0.5f) : I32(multi_f - 0.5f);
        if (multi == 1) {
          enc[L_GPS].encodeSymbol(x.m_gpstime_multi, 1);
          x.ic_gpstime.compress(enc[L_GPS], x.last_gpstime_diff[x.last_seq],
                                curr_diff, 1);
          x.multi_extreme_counter[x.last_seq] = 0;
        } else if (multi > 0) {
          if (multi < GPS_MULTI) {
            enc[L_GPS].encodeSymbol(x.m_gpstime_multi, U32(multi));
            if (multi < 10)
              x.ic_gpstime.compress(enc[L_GPS],
                                    multi * x.last_gpstime_diff[x.last_seq],
                                    curr_diff, 2);
            else
              x.ic_gpstime.compress(enc[L_GPS],
                                    multi * x.last_gpstime_diff[x.last_seq],
                                    curr_diff, 3);
          } else {
            enc[L_GPS].encodeSymbol(x.m_gpstime_multi, U32(GPS_MULTI));
            x.ic_gpstime.compress(
                enc[L_GPS], GPS_MULTI * x.last_gpstime_diff[x.last_seq],
                curr_diff, 4);
            x.multi_extreme_counter[x.last_seq]++;
            if (x.multi_extreme_counter[x.last_seq] > 3) {
              x.last_gpstime_diff[x.last_seq] = curr_diff;
              x.multi_extreme_counter[x.last_seq] = 0;
            }
          }
        } else if (multi < 0) {
          if (multi > GPS_MULTI_MINUS) {
            enc[L_GPS].encodeSymbol(x.m_gpstime_multi, U32(GPS_MULTI - multi));
            x.ic_gpstime.compress(enc[L_GPS],
                                  multi * x.last_gpstime_diff[x.last_seq],
                                  curr_diff, 5);
          } else {
            enc[L_GPS].encodeSymbol(x.m_gpstime_multi,
                                    U32(GPS_MULTI - GPS_MULTI_MINUS));
            x.ic_gpstime.compress(
                enc[L_GPS],
                GPS_MULTI_MINUS * x.last_gpstime_diff[x.last_seq], curr_diff,
                6);
            x.multi_extreme_counter[x.last_seq]++;
            if (x.multi_extreme_counter[x.last_seq] > 3) {
              x.last_gpstime_diff[x.last_seq] = curr_diff;
              x.multi_extreme_counter[x.last_seq] = 0;
            }
          }
        } else {
          enc[L_GPS].encodeSymbol(x.m_gpstime_multi, 0);
          x.ic_gpstime.compress(enc[L_GPS], 0, curr_diff, 7);
          x.multi_extreme_counter[x.last_seq]++;
          if (x.multi_extreme_counter[x.last_seq] > 3) {
            x.last_gpstime_diff[x.last_seq] = curr_diff;
            x.multi_extreme_counter[x.last_seq] = 0;
          }
        }
        x.last_gpstime[x.last_seq].i64 = t.i64;
      } else {
        for (U32 i = 1; i < 4; i++) {
          I64 other = t.i64 - x.last_gpstime[(x.last_seq + i) & 3].i64;
          if (other == I64(I32(other))) {
            enc[L_GPS].encodeSymbol(x.m_gpstime_multi,
                                    GPS_MULTI_CODE_FULL + i);
            x.last_seq = (x.last_seq + i) & 3;
            writeGpsTime(x, t);
            return;
          }
        }
        enc[L_GPS].encodeSymbol(x.m_gpstime_multi, GPS_MULTI_CODE_FULL);
        x.ic_gpstime.compress(enc[L_GPS],
                              I32(x.last_gpstime[x.last_seq].u64 >> 32),
                              I32(t.u64 >> 32), 8);
        enc[L_GPS].writeInt(U32(t.u64));
        x.next_seq = (x.next_seq + 1) & 3;
        x.last_seq = x.next_seq;
        x.last_gpstime_diff[x.last_seq] = 0;
        x.multi_extreme_counter[x.last_seq] = 0;
        x.last_gpstime[x.last_seq].i64 = t.i64;
      }
    }
  }

  void init(const U8* first_wire, bool compress, U32& context) {
    for_compress = compress;
    init_level_8ctx();
    for (int c = 0; c < 4; c++) ctx[c].unused = true;
    LasPoint14 seed;
    unpack14(first_wire, seed);
    cc = seed.scanner_channel;
    context = cc;
    initContext(cc, seed);
    if (compress)
      for (int l = 0; l < P14_NLAYERS; l++) {
        enc[l].init();
        changed[l] = false;
      }
  }

  void read(U8* wire_out, U32& context) {
    LasPoint14* last = &ctx[cc].last;

    // -------- channel_returns_XY layer ---------------------------------
    U32 lpr = (last->return_number == 1 ? 1u : 0u) |
              (last->return_number >= last->number_of_returns ? 2u : 0u) |
              (last->gps_time_change ? 4u : 0u);
    U32 cv = dec[L_XY].decodeSymbol(ctx[cc].m_changed_values[lpr]);

    if (cv & (1 << 6)) {  // scanner channel changed
      U32 diff = dec[L_XY].decodeSymbol(ctx[cc].m_scanner_channel);
      U32 sc = (cc + diff + 1) & 3;
      if (ctx[sc].unused) initContext(sc, ctx[cc].last);
      cc = sc;
      last = &ctx[cc].last;
      last->scanner_channel = U8(sc);
    }
    context = cc;
    Point14Ctx& x = ctx[cc];

    bool point_source_change = (cv & (1 << 5)) != 0;
    bool gps_time_change = (cv & (1 << 4)) != 0;
    bool scan_angle_change = (cv & (1 << 3)) != 0;

    U32 last_n = last->number_of_returns;
    U32 last_r = last->return_number;

    U32 n;
    if (cv & (1 << 2)) {
      n = dec[L_XY].decodeSymbol(*lazy(x.m_number_of_returns[last_n], 16));
      last->number_of_returns = U8(n);
    } else {
      n = last_n;
    }

    U32 r;
    switch (cv & 3) {
      case 0: r = last_r; break;
      case 1: r = (last_r + 1) & 15; last->return_number = U8(r); break;
      case 2: r = (last_r + 15) & 15; last->return_number = U8(r); break;
      default:
        if (gps_time_change) {
          r = dec[L_XY].decodeSymbol(*lazy(x.m_return_number[last_r], 16));
        } else {
          U32 sym = dec[L_XY].decodeSymbol(x.m_return_number_gps_same);
          r = (last_r + sym + 2) & 15;
        }
        last->return_number = U8(r);
        break;
    }

    U32 m = number_return_map_6ctx[n][r];
    U32 l = number_return_level_8ctx[n][r];
    U32 cpr = (r == 1 ? 2u : 0u) + (r >= n ? 1u : 0u);

    U32 gidx = (m << 1) | U32(gps_time_change);
    I32 median = x.last_X_diff_median5[gidx].get();
    I32 diff = x.ic_dX.decompress(dec[L_XY], median, n == 1);
    last->X += diff;
    x.last_X_diff_median5[gidx].add(diff);

    median = x.last_Y_diff_median5[gidx].get();
    U32 k_bits = x.ic_dX.k;
    diff = x.ic_dY.decompress(dec[L_XY], median,
                              (n == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20));
    last->Y += diff;
    x.last_Y_diff_median5[gidx].add(diff);

    // -------- Z layer ----------------------------------------------------
    if (changed[L_Z]) {
      k_bits = (x.ic_dX.k + x.ic_dY.k) / 2;
      last->Z = x.ic_Z.decompress(
          dec[L_Z], x.last_Z[l],
          (n == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18));
      x.last_Z[l] = last->Z;
    }

    // -------- classification layer --------------------------------------
    if (changed[L_CLS]) {
      U32 ccc = ((last->classification & 0x1F) << 1) + (cpr == 3 ? 1 : 0);
      last->classification =
          U8(dec[L_CLS].decodeSymbol(*lazy(x.m_classification[ccc], 256)));
    }

    // -------- flags layer -------------------------------------------------
    if (changed[L_FLG]) {
      U32 last_flags = (U32(last->edge_of_flight_line) << 5) |
                       (U32(last->scan_direction_flag) << 4) |
                       last->classification_flags;
      U32 flags = dec[L_FLG].decodeSymbol(*lazy(x.m_flags[last_flags], 64));
      last->edge_of_flight_line = U8((flags >> 5) & 1);
      last->scan_direction_flag = U8((flags >> 4) & 1);
      last->classification_flags = U8(flags & 0x0F);
    }

    // -------- intensity layer ---------------------------------------------
    if (changed[L_INT]) {
      U32 iidx = (cpr << 1) | U32(gps_time_change);
      U16 intensity = U16(x.ic_intensity.decompress(
          dec[L_INT], x.last_intensity[iidx], cpr));
      x.last_intensity[iidx] = intensity;
      last->intensity = intensity;
    }

    // -------- scan angle layer --------------------------------------------
    if (changed[L_SCA] && scan_angle_change) {
      last->scan_angle = I16(x.ic_scan_angle.decompress(
          dec[L_SCA], last->scan_angle, gps_time_change));
    }

    // -------- user data layer ---------------------------------------------
    if (changed[L_UD]) {
      last->user_data =
          U8(dec[L_UD].decodeSymbol(*lazy(x.m_user_data[last->user_data / 4],
                                          256)));
    }

    // -------- point source layer ------------------------------------------
    if (changed[L_PS] && point_source_change) {
      last->point_source_ID = U16(x.ic_point_source_ID.decompress(
          dec[L_PS], last->point_source_ID, 0));
    }

    // -------- gps time layer ----------------------------------------------
    if (changed[L_GPS] && gps_time_change) {
      readGpsTime(x);
      last->gps_time = x.last_gpstime[x.last_seq];
    }

    last->gps_time_change = gps_time_change;
    pack14(*last, wire_out);
  }

  void write(const U8* wire_in, U32& context) {
    LasPoint14 item;
    unpack14(wire_in, item);
    LasPoint14* last = &ctx[cc].last;

    // lpr from the current (pre-switch) context's last point
    U32 lpr = (last->return_number == 1 ? 1u : 0u) |
              (last->return_number >= last->number_of_returns ? 2u : 0u) |
              (last->gps_time_change ? 4u : 0u);

    // change bits compare against the TARGET scanner channel's last point
    // (seeded from the current one if that channel is still unused)
    U32 sc = item.scanner_channel & 3;
    bool channel_change = (sc != cc);
    LasPoint14* cmp = last;
    if (channel_change && !ctx[sc].unused) cmp = &ctx[sc].last;

    bool point_source_change = item.point_source_ID != cmp->point_source_ID;
    bool gps_time_change = item.gps_time.f64 != cmp->gps_time.f64;
    bool scan_angle_change = item.scan_angle != cmp->scan_angle;
    U32 n = item.number_of_returns, r = item.return_number;
    U32 last_n = cmp->number_of_returns, last_r = cmp->return_number;

    U32 cv = (U32(channel_change) << 6) | (U32(point_source_change) << 5) |
             (U32(gps_time_change) << 4) | (U32(scan_angle_change) << 3) |
             (U32(n != last_n) << 2);
    if (r != last_r) {
      if (r == ((last_r + 1) & 15)) cv |= 1;
      else if (r == ((last_r + 15) & 15)) cv |= 2;
      else cv |= 3;
    }
    enc[L_XY].encodeSymbol(ctx[cc].m_changed_values[lpr], cv);

    if (channel_change) {
      U32 diff = (sc - cc - 1) & 3;
      enc[L_XY].encodeSymbol(ctx[cc].m_scanner_channel, diff);
      if (ctx[sc].unused) initContext(sc, ctx[cc].last);
      cc = sc;
      last = &ctx[cc].last;
      last->scanner_channel = U8(sc);
    }
    context = cc;
    Point14Ctx& x = ctx[cc];

    if (cv & (1 << 2))
      enc[L_XY].encodeSymbol(*lazy(x.m_number_of_returns[last_n], 16), n);
    if ((cv & 3) == 3) {
      if (gps_time_change)
        enc[L_XY].encodeSymbol(*lazy(x.m_return_number[last_r], 16), r);
      else
        enc[L_XY].encodeSymbol(x.m_return_number_gps_same,
                               (r + 16 - last_r - 2) & 15);
    }

    U32 m = number_return_map_6ctx[n][r];
    U32 l = number_return_level_8ctx[n][r];
    U32 cpr = (r == 1 ? 2u : 0u) + (r >= n ? 1u : 0u);

    U32 gidx = (m << 1) | U32(gps_time_change);
    I32 median = x.last_X_diff_median5[gidx].get();
    I32 diff = I32(U32(item.X) - U32(last->X));
    x.ic_dX.compress(enc[L_XY], median, diff, n == 1);
    x.last_X_diff_median5[gidx].add(diff);

    median = x.last_Y_diff_median5[gidx].get();
    U32 k_bits = x.ic_dX.k;
    diff = I32(U32(item.Y) - U32(last->Y));
    x.ic_dY.compress(enc[L_XY], median, diff,
                     (n == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20));
    x.last_Y_diff_median5[gidx].add(diff);

    // Z layer (always coded; dropped whole if no point ever changed)
    k_bits = (x.ic_dX.k + x.ic_dY.k) / 2;
    if (item.Z != last->Z) changed[L_Z] = true;
    x.ic_Z.compress(enc[L_Z], x.last_Z[l], item.Z,
                    (n == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18));
    x.last_Z[l] = item.Z;

    // classification layer
    if (item.classification != last->classification) changed[L_CLS] = true;
    {
      U32 ccc = ((last->classification & 0x1F) << 1) + (cpr == 3 ? 1 : 0);
      enc[L_CLS].encodeSymbol(*lazy(x.m_classification[ccc], 256),
                              item.classification);
    }

    // flags layer
    {
      U32 last_flags = (U32(last->edge_of_flight_line) << 5) |
                       (U32(last->scan_direction_flag) << 4) |
                       last->classification_flags;
      U32 flags = (U32(item.edge_of_flight_line) << 5) |
                  (U32(item.scan_direction_flag) << 4) |
                  item.classification_flags;
      if (flags != last_flags) changed[L_FLG] = true;
      enc[L_FLG].encodeSymbol(*lazy(x.m_flags[last_flags], 64), flags);
    }

    // intensity layer
    if (item.intensity != last->intensity) changed[L_INT] = true;
    {
      U32 iidx = (cpr << 1) | U32(gps_time_change);
      x.ic_intensity.compress(enc[L_INT], x.last_intensity[iidx],
                              item.intensity, cpr);
      x.last_intensity[iidx] = item.intensity;
    }

    // scan angle layer (coded only when changed)
    if (scan_angle_change) {
      changed[L_SCA] = true;
      x.ic_scan_angle.compress(enc[L_SCA], last->scan_angle,
                               I32(U16(item.scan_angle)), gps_time_change);
    }

    // user data layer
    if (item.user_data != last->user_data) changed[L_UD] = true;
    enc[L_UD].encodeSymbol(*lazy(x.m_user_data[last->user_data / 4], 256),
                           item.user_data);

    // point source layer (coded only when changed)
    if (point_source_change) {
      changed[L_PS] = true;
      x.ic_point_source_ID.compress(enc[L_PS], last->point_source_ID,
                                    item.point_source_ID, 0);
    }

    // gps time layer (coded only when changed)
    if (gps_time_change) {
      changed[L_GPS] = true;
      writeGpsTime(x, item.gps_time);
    }

    *last = item;
    last->gps_time_change = gps_time_change;
  }
};

// ---------------------------------------------------------- RGB14 v3 -------

struct Rgb14Ctx {
  bool unused;
  U16 last[3];
  U16 last_nir;
  ArithmeticModel m_byte_used, m_rgb_diff[6];
  ArithmeticModel m_nir_bytes_used, m_nir_diff[2];
};

struct Rgb14v3 {
  bool for_compress, with_nir;
  Rgb14Ctx ctx[4];
  U32 cc;
  // Last-value pointers follow laszip's v3 reader/writer semantics:
  // re-fetched from the CURRENT context at the start of every call, and
  // reassigned during a context switch only when the target context was
  // unused — so a switch to a USED context predicts from (and updates!)
  // the previous context's last values for that one point.  Required for
  // bit-compatibility; verified on the format-7/8 fixtures where scanner
  // channels cycle 0..3.
  U16* last;      // -> some ctx[..].last
  U16* last_nir;  // -> some ctx[..].last_nir
  Decoder dec_rgb, dec_nir;
  Encoder enc_rgb, enc_nir;
  bool changed_rgb = false, changed_nir = false;

  void initContext(U32 c, const U16* seed_rgb, U16 seed_nir) {
    Rgb14Ctx& x = ctx[c];
    x.m_byte_used.init(128, for_compress);
    for (int i = 0; i < 6; i++) x.m_rgb_diff[i].init(256, for_compress);
    if (with_nir) {
      x.m_nir_bytes_used.init(4, for_compress);
      x.m_nir_diff[0].init(256, for_compress);
      x.m_nir_diff[1].init(256, for_compress);
    }
    std::memcpy(x.last, seed_rgb, 6);
    x.last_nir = seed_nir;
    x.unused = false;
  }

  void init(const U8* first_wire, bool nir, bool compress, U32 context) {
    for_compress = compress;
    with_nir = nir;
    for (int c = 0; c < 4; c++) ctx[c].unused = true;
    cc = context & 3;
    U16 rgbv[3], nv = 0;
    std::memcpy(rgbv, first_wire, 6);
    if (nir) std::memcpy(&nv, first_wire + 6, 2);
    initContext(cc, rgbv, nv);
    last = ctx[cc].last;
    last_nir = &ctx[cc].last_nir;
    if (compress) {
      enc_rgb.init();
      enc_nir.init();
      changed_rgb = changed_nir = false;
    }
  }

  void switchContext(U32 context) {
    context &= 3;
    if (cc != context) {
      cc = context;
      if (ctx[cc].unused) {
        U16 seed[3];
        std::memcpy(seed, last, 6);
        initContext(cc, seed, *last_nir);
        last = ctx[cc].last;
        last_nir = &ctx[cc].last_nir;
      }
      // used context: keep updating the previous context's last values
    }
  }

  void read(U8* wire_out, U32 context) {
    last = ctx[cc].last;
    last_nir = &ctx[cc].last_nir;
    switchContext(context);
    Rgb14Ctx& x = ctx[cc];
    if (changed_rgb) {
      U16 r, g, b;
      I32 diff;
      U32 corr;
      U32 sym = dec_rgb.decodeSymbol(x.m_byte_used);
      if (sym & 1) {
        corr = dec_rgb.decodeSymbol(x.m_rgb_diff[0]);
        r = U16(u8_fold(I32(corr) + (last[0] & 0xFF)));
      } else {
        r = last[0] & 0xFF;
      }
      if (sym & 2) {
        corr = dec_rgb.decodeSymbol(x.m_rgb_diff[1]);
        r |= U16(u8_fold(I32(corr) + (last[0] >> 8))) << 8;
      } else {
        r |= last[0] & 0xFF00;
      }
      if (sym & 64) {
        diff = (r & 0xFF) - (last[0] & 0xFF);
        if (sym & 4) {
          corr = dec_rgb.decodeSymbol(x.m_rgb_diff[2]);
          g = U16(u8_fold(I32(corr) + u8_clamp(diff + (last[1] & 0xFF))));
        } else {
          g = last[1] & 0xFF;
        }
        if (sym & 16) {
          corr = dec_rgb.decodeSymbol(x.m_rgb_diff[4]);
          diff = (diff + ((g & 0xFF) - (last[1] & 0xFF))) / 2;
          b = U16(u8_fold(I32(corr) + u8_clamp(diff + (last[2] & 0xFF))));
        } else {
          b = last[2] & 0xFF;
        }
        diff = (r >> 8) - (last[0] >> 8);
        if (sym & 8) {
          corr = dec_rgb.decodeSymbol(x.m_rgb_diff[3]);
          g |= U16(u8_fold(I32(corr) + u8_clamp(diff + (last[1] >> 8))))
               << 8;
        } else {
          g |= last[1] & 0xFF00;
        }
        if (sym & 32) {
          corr = dec_rgb.decodeSymbol(x.m_rgb_diff[5]);
          diff = (diff + ((g >> 8) - (last[1] >> 8))) / 2;
          b |= U16(u8_fold(I32(corr) + u8_clamp(diff + (last[2] >> 8))))
               << 8;
        } else {
          b |= last[2] & 0xFF00;
        }
      } else {
        g = r;
        b = r;
      }
      last[0] = r;
      last[1] = g;
      last[2] = b;
    }
    std::memcpy(wire_out, last, 6);
    if (with_nir) {
      if (changed_nir) {
        U32 sym = dec_nir.decodeSymbol(x.m_nir_bytes_used);
        U16 nir;
        if (sym & 1) {
          U32 corr = dec_nir.decodeSymbol(x.m_nir_diff[0]);
          nir = U16(u8_fold(I32(corr) + ((*last_nir) & 0xFF)));
        } else {
          nir = (*last_nir) & 0xFF;
        }
        if (sym & 2) {
          U32 corr = dec_nir.decodeSymbol(x.m_nir_diff[1]);
          nir |= U16(u8_fold(I32(corr) + ((*last_nir) >> 8))) << 8;
        } else {
          nir |= (*last_nir) & 0xFF00;
        }
        (*last_nir) = nir;
      }
      std::memcpy(wire_out + 6, last_nir, 2);
    }
  }

  void write(const U8* wire_in, U32 context) {
    last = ctx[cc].last;
    last_nir = &ctx[cc].last_nir;
    switchContext(context);
    Rgb14Ctx& x = ctx[cc];
    U16 r, g, b;
    std::memcpy(&r, wire_in + 0, 2);
    std::memcpy(&g, wire_in + 2, 2);
    std::memcpy(&b, wire_in + 4, 2);

    U32 sym = 0;
    if ((r & 0xFF) != (last[0] & 0xFF)) sym |= 1;
    if ((r >> 8) != (last[0] >> 8)) sym |= 2;
    bool gb_differ = ((r & 0xFF) != (g & 0xFF)) || ((r & 0xFF) != (b & 0xFF)) ||
                     ((r >> 8) != (g >> 8)) || ((r >> 8) != (b >> 8));
    if (gb_differ) {
      sym |= 64;
      if ((g & 0xFF) != (last[1] & 0xFF)) sym |= 4;
      if ((g >> 8) != (last[1] >> 8)) sym |= 8;
      if ((b & 0xFF) != (last[2] & 0xFF)) sym |= 16;
      if ((b >> 8) != (last[2] >> 8)) sym |= 32;
    }
    if (r != last[0] || g != last[1] || b != last[2])
      changed_rgb = true;
    enc_rgb.encodeSymbol(x.m_byte_used, sym);
    I32 diff;
    if (sym & 1)
      enc_rgb.encodeSymbol(x.m_rgb_diff[0],
                           u8_fold(I32(r & 0xFF) - I32(last[0] & 0xFF)));
    if (sym & 2)
      enc_rgb.encodeSymbol(x.m_rgb_diff[1],
                           u8_fold(I32(r >> 8) - I32(last[0] >> 8)));
    if (sym & 64) {
      diff = (r & 0xFF) - (last[0] & 0xFF);
      if (sym & 4)
        enc_rgb.encodeSymbol(
            x.m_rgb_diff[2],
            u8_fold(I32(g & 0xFF) - u8_clamp(diff + (last[1] & 0xFF))));
      if (sym & 16) {
        diff = (diff + ((g & 0xFF) - (last[1] & 0xFF))) / 2;
        enc_rgb.encodeSymbol(
            x.m_rgb_diff[4],
            u8_fold(I32(b & 0xFF) - u8_clamp(diff + (last[2] & 0xFF))));
      }
      diff = (r >> 8) - (last[0] >> 8);
      if (sym & 8)
        enc_rgb.encodeSymbol(
            x.m_rgb_diff[3],
            u8_fold(I32(g >> 8) - u8_clamp(diff + (last[1] >> 8))));
      if (sym & 32) {
        diff = (diff + ((g >> 8) - (last[1] >> 8))) / 2;
        enc_rgb.encodeSymbol(
            x.m_rgb_diff[5],
            u8_fold(I32(b >> 8) - u8_clamp(diff + (last[2] >> 8))));
      }
    }
    last[0] = r;
    last[1] = g;
    last[2] = b;

    if (with_nir) {
      U16 nir;
      std::memcpy(&nir, wire_in + 6, 2);
      U32 nsym = 0;
      if ((nir & 0xFF) != ((*last_nir) & 0xFF)) nsym |= 1;
      if ((nir >> 8) != ((*last_nir) >> 8)) nsym |= 2;
      if (nir != (*last_nir)) changed_nir = true;
      enc_nir.encodeSymbol(x.m_nir_bytes_used, nsym);
      if (nsym & 1)
        enc_nir.encodeSymbol(
            x.m_nir_diff[0],
            u8_fold(I32(nir & 0xFF) - I32((*last_nir) & 0xFF)));
      if (nsym & 2)
        enc_nir.encodeSymbol(x.m_nir_diff[1],
                             u8_fold(I32(nir >> 8) - I32((*last_nir) >> 8)));
      (*last_nir) = nir;
    }
  }
};

// ---------------------------------------------------------- BYTE14 v3 ------

struct Byte14Ctx {
  bool unused;
  std::vector<U8> last;
  std::vector<ArithmeticModel> m_bytes;  // one 256-sym model per byte
};

struct Byte14v3 {
  bool for_compress;
  U32 number = 0;
  Byte14Ctx ctx[4];
  U32 cc;
  U8* last = nullptr;  // roaming pointer, same semantics as Rgb14v3::last
  std::vector<Decoder> dec;    // one per byte layer
  std::vector<Encoder> enc;
  std::vector<U8> changed;     // per byte layer

  void initContext(U32 c, const U8* seed) {
    Byte14Ctx& x = ctx[c];
    x.m_bytes.resize(number);
    for (U32 i = 0; i < number; i++) x.m_bytes[i].init(256, for_compress);
    x.last.assign(seed, seed + number);
    x.unused = false;
  }

  void init(const U8* first_wire, U32 n, bool compress, U32 context) {
    for_compress = compress;
    number = n;
    for (int c = 0; c < 4; c++) ctx[c].unused = true;
    cc = context & 3;
    initContext(cc, first_wire);
    last = ctx[cc].last.data();
    dec.assign(number, Decoder());
    enc.assign(number, Encoder());
    changed.assign(number, 0);
    if (compress)
      for (U32 i = 0; i < number; i++) enc[i].init();
  }

  void switchContext(U32 context) {
    context &= 3;
    if (cc != context) {
      cc = context;
      if (ctx[cc].unused) {
        std::vector<U8> seed(last, last + number);
        initContext(cc, seed.data());
        last = ctx[cc].last.data();
      }
      // used context: keep updating the previous context's last values
    }
  }

  void read(U8* wire_out, U32 context) {
    last = ctx[cc].last.data();
    switchContext(context);
    Byte14Ctx& x = ctx[cc];
    for (U32 i = 0; i < number; i++) {
      if (changed[i]) {
        U32 sym = dec[i].decodeSymbol(x.m_bytes[i]);
        last[i] = u8_fold(I32(sym) + I32(last[i]));
      }
      wire_out[i] = last[i];
    }
  }

  void write(const U8* wire_in, U32 context) {
    last = ctx[cc].last.data();
    switchContext(context);
    Byte14Ctx& x = ctx[cc];
    for (U32 i = 0; i < number; i++) {
      if (wire_in[i] != last[i]) changed[i] = 1;
      enc[i].encodeSymbol(x.m_bytes[i], u8_fold(I32(wire_in[i]) -
                                                I32(last[i])));
      last[i] = wire_in[i];
    }
  }
};

// ------------------------------------------------------------ item specs ----

enum ItemType : U16 {
  ITEM_BYTE = 0,
  ITEM_POINT10 = 6,
  ITEM_GPSTIME11 = 7,
  ITEM_RGB12 = 8,
  ITEM_WAVEPACKET13 = 9,
  ITEM_POINT14 = 10,
  ITEM_RGB14 = 11,
  ITEM_RGBNIR14 = 12,
  ITEM_WAVEPACKET14 = 13,
  ITEM_BYTE14 = 14,
};

struct ItemSpec {
  U16 type, size, version;
};

struct ChunkCodec {
  std::vector<ItemSpec> items;
  Point10v2 point10;
  Gpstime11v2 gpstime;
  Rgb12v2 rgb;
  Wavepacket13v1 wavepacket;
  Bytev2 bytes;

  // returns false on unsupported item
  bool supported() const {
    for (const auto& it : items) {
      switch (it.type) {
        case ITEM_POINT10:
          if (it.version != 2) return false;
          break;
        case ITEM_GPSTIME11:
          if (it.version != 2) return false;
          break;
        case ITEM_RGB12:
          if (it.version != 2) return false;
          break;
        case ITEM_WAVEPACKET13:
          if (it.version != 1) return false;
          break;
        case ITEM_BYTE:
          if (it.version != 2) return false;
          break;
        default:
          return false;
      }
    }
    return true;
  }

  void init(const U8* first_point, bool compress) {
    const U8* p = first_point;
    for (const auto& it : items) {
      switch (it.type) {
        case ITEM_POINT10: point10.init(p, compress); break;
        case ITEM_GPSTIME11: gpstime.init(p, compress); break;
        case ITEM_RGB12: rgb.init(p, compress); break;
        case ITEM_WAVEPACKET13: wavepacket.init(p, compress); break;
        case ITEM_BYTE: bytes.init(p, it.size, compress); break;
      }
      p += it.size;
    }
  }

  void readPoint(Decoder& dec, U8* out) {
    U8* p = out;
    for (const auto& it : items) {
      switch (it.type) {
        case ITEM_POINT10: point10.read(dec, p); break;
        case ITEM_GPSTIME11: gpstime.read(dec, p); break;
        case ITEM_RGB12: rgb.read(dec, p); break;
        case ITEM_WAVEPACKET13: wavepacket.read(dec, p); break;
        case ITEM_BYTE: bytes.read(dec, p); break;
      }
      p += it.size;
    }
  }

  void writePoint(Encoder& enc, const U8* in) {
    const U8* p = in;
    for (const auto& it : items) {
      switch (it.type) {
        case ITEM_POINT10: point10.write(enc, p); break;
        case ITEM_GPSTIME11: gpstime.write(enc, p); break;
        case ITEM_RGB12: rgb.write(enc, p); break;
        case ITEM_WAVEPACKET13: wavepacket.write(enc, p); break;
        case ITEM_BYTE: bytes.write(enc, p); break;
      }
      p += it.size;
    }
  }
};

// ------------------------------------------------- layered chunk codec ----

static bool items_layered(const std::vector<ItemSpec>& items) {
  for (const auto& it : items)
    if (it.type >= ITEM_POINT14) return true;
  return false;
}

static bool layered_supported(const std::vector<ItemSpec>& items) {
  if (items.empty() || items[0].type != ITEM_POINT14 || items[0].size != 30 ||
      items[0].version != 3)
    return false;
  for (size_t i = 1; i < items.size(); i++) {
    const auto& it = items[i];
    switch (it.type) {
      case ITEM_RGB14:
        if (it.size != 6 || it.version != 3) return false;
        break;
      case ITEM_RGBNIR14:
        if (it.size != 8 || it.version != 3) return false;
        break;
      case ITEM_BYTE14:
        if (it.size == 0 || it.version != 3) return false;
        break;
      default:
        // WAVEPACKET14 (formats 9/10) intentionally unsupported — the
        // reference rejects LAZ 9/10 too (raw_readers.rs:451-455)
        return false;
    }
  }
  return true;
}

// layered chunk: [raw first point][u32 count][u32 layer sizes][layer bytes]
static bool decompress_chunk_layered(const U8* in, size_t in_len, U8* out,
                                     U64 npoints,
                                     const std::vector<ItemSpec>& items,
                                     U32 point_size) {
  if (npoints == 0) return true;
  if (in_len < point_size) return false;
  std::memcpy(out, in, point_size);
  if (npoints == 1) return true;

  size_t pos = point_size;
  auto read_u32 = [&](U32& v) -> bool {
    if (pos + 4 > in_len) return false;
    std::memcpy(&v, in + pos, 4);
    pos += 4;
    return true;
  };
  U32 count;
  if (!read_u32(count) || count != npoints) return false;

  Point14v3 p14;
  Rgb14v3 rgb;
  Byte14v3 extra;
  bool has_rgb = false, has_nir = false;
  U32 nbytes_extra = 0;

  // layer sizes, in item order
  U32 p14_sizes[P14_NLAYERS];
  for (int l = 0; l < P14_NLAYERS; l++)
    if (!read_u32(p14_sizes[l])) return false;
  U32 rgb_size = 0, nir_size = 0;
  std::vector<U32> extra_sizes;
  for (size_t i = 1; i < items.size(); i++) {
    const auto& it = items[i];
    if (it.type == ITEM_RGB14) {
      has_rgb = true;
      if (!read_u32(rgb_size)) return false;
    } else if (it.type == ITEM_RGBNIR14) {
      has_rgb = has_nir = true;
      if (!read_u32(rgb_size) || !read_u32(nir_size)) return false;
    } else {  // BYTE14
      nbytes_extra = it.size;
      extra_sizes.resize(nbytes_extra);
      for (U32 b = 0; b < nbytes_extra; b++)
        if (!read_u32(extra_sizes[b])) return false;
    }
  }

  // wire offsets of the items within a record
  U32 rgb_off = 30;
  U32 extra_off = 30 + (has_nir ? 8 : (has_rgb ? 6 : 0));

  // init codecs from the raw first point, then hand each layer its bytes
  U32 context = 0;
  p14.init(out, false, context);
  if (has_rgb) rgb.init(out + rgb_off, has_nir, false, context);
  if (nbytes_extra) extra.init(out + extra_off, nbytes_extra, false, context);

  auto attach = [&](Decoder& d, U32 size) -> bool {
    if (pos + size > in_len) return false;
    d.buf = in + pos;
    d.pos = 0;
    d.size = size;
    d.overrun = false;
    if (size) d.init();
    pos += size;
    return true;
  };
  for (int l = 0; l < P14_NLAYERS; l++) {
    if (!attach(p14.dec[l], p14_sizes[l])) return false;
    p14.changed[l] = p14_sizes[l] != 0;
  }
  if (has_rgb) {
    if (!attach(rgb.dec_rgb, rgb_size)) return false;
    rgb.changed_rgb = rgb_size != 0;
    if (has_nir) {
      if (!attach(rgb.dec_nir, nir_size)) return false;
      rgb.changed_nir = nir_size != 0;
    }
  }
  for (U32 b = 0; b < nbytes_extra; b++) {
    if (!attach(extra.dec[b], extra_sizes[b])) return false;
    extra.changed[b] = extra_sizes[b] != 0;
  }

  for (U64 i = 1; i < npoints; i++) {
    U8* rec = out + i * point_size;
    U32 ctx = 0;
    p14.read(rec, ctx);
    if (has_rgb) rgb.read(rec + rgb_off, ctx);
    if (nbytes_extra) extra.read(rec + extra_off, ctx);
    for (int l = 0; l < P14_NLAYERS; l++)
      if (p14.dec[l].overrun && p14.dec[l].pos > p14.dec[l].size + 16)
        return false;
  }
  return true;
}

static void compress_chunk_layered(const U8* in, U64 npoints,
                                   const std::vector<ItemSpec>& items,
                                   U32 point_size, std::vector<U8>& out) {
  if (npoints == 0) {
    out.clear();
    return;
  }
  out.assign(in, in + point_size);

  Point14v3 p14;
  Rgb14v3 rgb;
  Byte14v3 extra;
  bool has_rgb = false, has_nir = false;
  U32 nbytes_extra = 0;
  for (size_t i = 1; i < items.size(); i++) {
    if (items[i].type == ITEM_RGB14) has_rgb = true;
    else if (items[i].type == ITEM_RGBNIR14) has_rgb = has_nir = true;
    else nbytes_extra = items[i].size;
  }
  U32 rgb_off = 30;
  U32 extra_off = 30 + (has_nir ? 8 : (has_rgb ? 6 : 0));

  U32 context = 0;
  p14.init(in, true, context);
  if (has_rgb) rgb.init(in + rgb_off, has_nir, true, context);
  if (nbytes_extra) extra.init(in + extra_off, nbytes_extra, true, context);

  for (U64 i = 1; i < npoints; i++) {
    const U8* rec = in + i * point_size;
    U32 ctx = 0;
    p14.write(rec, ctx);
    if (has_rgb) rgb.write(rec + rgb_off, ctx);
    if (nbytes_extra) extra.write(rec + extra_off, ctx);
  }

  // finalize layers; unchanged layers are dropped entirely (size 0) and
  // the reader reproduces the constant value from the raw first point
  auto finish = [](Encoder& e, bool keep) -> std::vector<U8> {
    if (!keep) return {};
    e.done();
    return std::move(e.out);
  };
  std::vector<std::vector<U8>> blocks;
  blocks.push_back(finish(p14.enc[L_XY], true));
  for (int l = 1; l < P14_NLAYERS; l++)
    blocks.push_back(finish(p14.enc[l], p14.changed[l]));
  if (has_rgb) {
    blocks.push_back(finish(rgb.enc_rgb, rgb.changed_rgb));
    if (has_nir) blocks.push_back(finish(rgb.enc_nir, rgb.changed_nir));
  }
  for (U32 b = 0; b < nbytes_extra; b++)
    blocks.push_back(finish(extra.enc[b], extra.changed[b] != 0));

  U32 count = U32(npoints);
  out.insert(out.end(), (U8*)&count, (U8*)&count + 4);
  for (auto& blk : blocks) {
    U32 sz = U32(blk.size());
    out.insert(out.end(), (U8*)&sz, (U8*)&sz + 4);
  }
  for (auto& blk : blocks) out.insert(out.end(), blk.begin(), blk.end());
}

// decompress one chunk: [raw first point][arith stream] -> npoints records
static bool decompress_chunk(const U8* in, size_t in_len, U8* out,
                             U64 npoints, const std::vector<ItemSpec>& items,
                             U32 point_size) {
  if (npoints == 0) return true;
  if (in_len < point_size) return false;
  std::memcpy(out, in, point_size);
  if (npoints == 1) return true;

  ChunkCodec codec;
  codec.items = items;
  if (!codec.supported()) return false;
  codec.init(out, false);

  Decoder dec;
  dec.buf = in;
  dec.pos = point_size;
  dec.size = in_len;
  dec.init();
  for (U64 i = 1; i < npoints; i++) {
    codec.readPoint(dec, out + i * point_size);
    // the range coder legitimately reads a few bytes past the payload at
    // the end of a chunk (the encoder's done() under-writes the tail);
    // anything further means the stream went off the rails
    if (dec.overrun && dec.pos > dec.size + 16) return false;
  }
  return true;
}

static void compress_chunk(const U8* in, U64 npoints,
                           const std::vector<ItemSpec>& items, U32 point_size,
                           std::vector<U8>& out) {
  out.assign(in, in + point_size);
  if (npoints <= 1) return;
  ChunkCodec codec;
  codec.items = items;
  codec.init(in, true);
  Encoder enc;
  enc.init();
  for (U64 i = 1; i < npoints; i++) codec.writePoint(enc, in + i * point_size);
  enc.done();
  out.insert(out.end(), enc.out.begin(), enc.out.end());
}

static std::vector<ItemSpec> unpack_items(const U16* items, U32 nitems) {
  std::vector<ItemSpec> out(nitems);
  for (U32 i = 0; i < nitems; i++)
    out[i] = {items[3 * i], items[3 * i + 1], items[3 * i + 2]};
  return out;
}

}  // namespace

// ------------------------------------------------------------ public API ----

extern "C" {

// Decompress points [start, start+count) into `out` (count*point_size bytes).
// Returns 0 on success, negative error code otherwise.
int laz_decompress(const uint8_t* file, uint64_t file_len,
                   uint64_t point_data_offset, uint64_t npoints,
                   uint32_t point_size, uint32_t chunk_size,
                   const uint16_t* items, uint32_t nitems, uint64_t start,
                   uint64_t count, uint8_t* out, int nthreads) {
  if (point_data_offset + 8 > file_len) return -1;
  auto specs = unpack_items(items, nitems);
  const bool layered = items_layered(specs);
  if (layered) {
    if (!layered_supported(specs)) return -2;
  } else {
    ChunkCodec probe;
    probe.items = specs;
    if (!probe.supported()) return -2;
  }
  const bool variable = (chunk_size == 0xFFFFFFFFu);

  // chunk table: i64 absolute offset at the start of the point data
  I64 table_off;
  std::memcpy(&table_off, file + point_data_offset, 8);
  if (table_off < 0 || U64(table_off) + 8 > file_len) return -3;

  U32 version, number_chunks;
  std::memcpy(&version, file + table_off, 4);
  std::memcpy(&number_chunks, file + table_off + 4, 4);
  if (!variable) {
    U64 expected_chunks =
        chunk_size ? (npoints + chunk_size - 1) / chunk_size : 1;
    if (number_chunks != expected_chunks) return -4;
  }

  // chunk sizes (and, for variable-size chunks, point counts) are
  // entropy-coded: IntegerCompressor 32-bit / 2 contexts, counts under
  // context 0 and byte sizes under context 1, each predicted by the
  // previous chunk's value
  std::vector<U32> sizes(number_chunks, 0), counts;
  if (variable) counts.assign(number_chunks, 0);
  if (number_chunks > 0) {
    Decoder dec;
    dec.buf = file;
    dec.pos = size_t(table_off) + 8;
    dec.size = file_len;
    dec.init();
    IntegerCodec ic;
    ic.setup(32, 2);
    ic.initModels(false);
    for (U32 i = 0; i < number_chunks; i++) {
      if (variable)
        counts[i] = U32(ic.decompress(dec, i ? I32(counts[i - 1]) : 0, 0));
      sizes[i] = U32(ic.decompress(dec, i ? I32(sizes[i - 1]) : 0, 1));
      if (dec.overrun && dec.pos > dec.size + 16) return -5;
    }
  }
  std::vector<U64> starts(number_chunks + 1), begins(number_chunks + 1);
  starts[0] = point_data_offset + 8;
  begins[0] = 0;
  for (U32 i = 0; i < number_chunks; i++) {
    starts[i + 1] = starts[i] + sizes[i];
    U64 c_points = variable
                       ? counts[i]
                       : std::min<U64>(chunk_size, npoints - begins[i]);
    begins[i + 1] = begins[i] + c_points;
  }
  if (starts[number_chunks] > U64(table_off)) return -6;
  if (begins[number_chunks] < npoints) return -4;

  // which chunks cover [start, start+count)?
  if (count == 0) return 0;
  U64 first_chunk = 0, last_chunk = 0;
  for (U32 c = 0; c < number_chunks; c++) {
    if (begins[c] <= start && start < begins[c + 1]) first_chunk = c;
    if (begins[c] < start + count && start + count <= begins[c + 1])
      last_chunk = c;
  }
  if (last_chunk >= number_chunks || last_chunk < first_chunk) return -7;

  struct Job {
    U64 chunk, chunk_points, skip, take, out_off;
  };
  std::vector<Job> jobs;
  U64 out_off = 0;
  for (U64 c = first_chunk; c <= last_chunk; c++) {
    U64 c_begin = begins[c];
    U64 c_points = begins[c + 1] - begins[c];
    U64 s = (start > c_begin) ? start - c_begin : 0;
    U64 e = std::min<U64>(c_points, start + count - c_begin);
    jobs.push_back({c, c_points, s, e - s, out_off});
    out_off += (e - s) * point_size;
  }

  std::vector<int> rc(jobs.size(), 0);
  auto work = [&](size_t j) {
    const Job& job = jobs[j];
    std::vector<U8> scratch(job.chunk_points * point_size);
    bool ok =
        layered
            ? decompress_chunk_layered(
                  file + starts[job.chunk],
                  starts[job.chunk + 1] - starts[job.chunk], scratch.data(),
                  job.chunk_points, specs, point_size)
            : decompress_chunk(file + starts[job.chunk],
                               starts[job.chunk + 1] - starts[job.chunk],
                               scratch.data(), job.chunk_points, specs,
                               point_size);
    if (!ok) {
      rc[j] = -8;
      return;
    }
    std::memcpy(out + job.out_off, scratch.data() + job.skip * point_size,
                job.take * point_size);
  };

  if (nthreads <= 1 || jobs.size() == 1) {
    for (size_t j = 0; j < jobs.size(); j++) work(j);
  } else {
    std::vector<std::thread> pool;
    std::atomic<size_t> next{0};
    size_t nt = std::min<size_t>(nthreads, jobs.size());
    for (size_t t = 0; t < nt; t++)
      pool.emplace_back([&]() {
        for (;;) {
          size_t j = next.fetch_add(1);
          if (j >= jobs.size()) break;
          work(j);
        }
      });
    for (auto& th : pool) th.join();
  }
  for (int r : rc)
    if (r) return r;
  return 0;
}

// Compress `npoints` records into a LAZ point-data block (leading chunk
// table offset + chunks + chunk table).  *out_ptr is malloc'd; free with
// laz_free.  Returns 0 on success.
int laz_compress(const uint8_t* records, uint64_t npoints,
                 uint32_t point_size, uint32_t chunk_size,
                 const uint16_t* items, uint32_t nitems, uint8_t** out_ptr,
                 uint64_t* out_len, int nthreads) {
  auto specs = unpack_items(items, nitems);
  const bool layered = items_layered(specs);
  if (layered) {
    if (!layered_supported(specs)) return -2;
  } else {
    ChunkCodec probe;
    probe.items = specs;
    if (!probe.supported()) return -2;
  }
  U64 number_chunks =
      chunk_size ? (npoints + chunk_size - 1) / chunk_size : (npoints ? 1 : 0);

  std::vector<std::vector<U8>> chunks(number_chunks);
  auto work = [&](size_t c) {
    U64 begin = c * U64(chunk_size);
    U64 n = std::min<U64>(chunk_size, npoints - begin);
    if (layered)
      compress_chunk_layered(records + begin * point_size, n, specs,
                             point_size, chunks[c]);
    else
      compress_chunk(records + begin * point_size, n, specs, point_size,
                     chunks[c]);
  };
  if (nthreads <= 1 || number_chunks <= 1) {
    for (size_t c = 0; c < number_chunks; c++) work(c);
  } else {
    std::vector<std::thread> pool;
    std::atomic<size_t> next{0};
    size_t nt = std::min<size_t>(nthreads, number_chunks);
    for (size_t t = 0; t < nt; t++)
      pool.emplace_back([&]() {
        for (;;) {
          size_t c = next.fetch_add(1);
          if (c >= number_chunks) break;
          work(c);
        }
      });
    for (auto& th : pool) th.join();
  }

  // chunk table (version 0, sizes entropy-coded as on read)
  Encoder enc;
  enc.init();
  IntegerCodec ic;
  ic.setup(32, 2);
  ic.initModels(true);
  for (U64 c = 0; c < number_chunks; c++)
    ic.compress(enc, c ? I32(U32(chunks[c - 1].size())) : 0,
                I32(U32(chunks[c].size())), 1);
  enc.done();

  U64 total = 8;
  for (auto& ch : chunks) total += ch.size();
  U64 table_pos_rel = total;
  total += 8 + enc.out.size();

  U8* out = static_cast<U8*>(std::malloc(total));
  if (!out) return -9;
  // table offset is written relative to 0 here; the Python driver adds the
  // absolute file position of the point data block
  I64 rel = I64(table_pos_rel);
  std::memcpy(out, &rel, 8);
  U64 off = 8;
  for (auto& ch : chunks) {
    std::memcpy(out + off, ch.data(), ch.size());
    off += ch.size();
  }
  U32 version = 0, nc32 = U32(number_chunks);
  std::memcpy(out + off, &version, 4);
  std::memcpy(out + off + 4, &nc32, 4);
  std::memcpy(out + off + 8, enc.out.data(), enc.out.size());

  *out_ptr = out;
  *out_len = total;
  return 0;
}

void laz_free(uint8_t* p) { std::free(p); }

// Override the POINT14 (number_of_returns, return_number) -> context
// tables (two 16x16 row-major byte arrays; pass NULL to keep a default).
// Escape hatch should a table entry not exercised by the verification
// fixtures ever prove divergent from laszip on a real-world file.
void laz_set_point14_tables(const uint8_t* map_6ctx,
                            const uint8_t* level_8ctx) {
  init_level_8ctx();
  if (map_6ctx) std::memcpy(number_return_map_6ctx, map_6ctx, 256);
  if (level_8ctx) std::memcpy(number_return_level_8ctx, level_8ctx, 256);
}

// Read back the active tables (table-sensitivity tests snapshot them
// before perturbation and restore afterwards).
void laz_get_point14_tables(uint8_t* map_6ctx, uint8_t* level_8ctx) {
  init_level_8ctx();
  if (map_6ctx) std::memcpy(map_6ctx, number_return_map_6ctx, 256);
  if (level_8ctx) std::memcpy(level_8ctx, number_return_level_8ctx, 256);
}

// Round-trip self-test of the coder primitives; returns 0 or a negative
// code identifying the first failing stage.
// Deinterleave fixed-size wire records into contiguous per-field
// columns — the host-ingest hot loop (SURVEY §3.1; the reference leans
// on mmap + per-point closures, raw_readers.rs:31-167).  numpy's
// strided field extraction re-walks the 30-60B records once PER FIELD;
// this walks them once per L2-sized row block and emits every column,
// parallel over row blocks.
void laz_deinterleave(const uint8_t* records, uint64_t n,
                      uint32_t record_size, const uint32_t* offsets,
                      const uint32_t* sizes, uint32_t n_fields,
                      uint8_t* const* outs, int nthreads) {
  const uint64_t block = 4096;
  auto do_range = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t b0 = lo; b0 < hi; b0 += block) {
      uint64_t b1 = std::min(b0 + block, hi);
      for (uint32_t f = 0; f < n_fields; f++) {
        const uint8_t* src = records + b0 * record_size + offsets[f];
        uint32_t sz = sizes[f];
        uint8_t* dst = outs[f] + b0 * sz;
        switch (sz) {
          case 1:
            for (uint64_t i = b0; i < b1; i++, src += record_size)
              *dst++ = *src;
            break;
          case 2:
            for (uint64_t i = b0; i < b1; i++, src += record_size) {
              uint16_t v;
              std::memcpy(&v, src, 2);
              std::memcpy(dst, &v, 2);
              dst += 2;
            }
            break;
          case 4:
            for (uint64_t i = b0; i < b1; i++, src += record_size) {
              uint32_t v;
              std::memcpy(&v, src, 4);
              std::memcpy(dst, &v, 4);
              dst += 4;
            }
            break;
          case 8:
            for (uint64_t i = b0; i < b1; i++, src += record_size) {
              uint64_t v;
              std::memcpy(&v, src, 8);
              std::memcpy(dst, &v, 8);
              dst += 8;
            }
            break;
          case 12:
            for (uint64_t i = b0; i < b1; i++, src += record_size) {
              uint64_t v;
              uint32_t w;
              std::memcpy(&v, src, 8);
              std::memcpy(&w, src + 8, 4);
              std::memcpy(dst, &v, 8);
              std::memcpy(dst + 8, &w, 4);
              dst += 12;
            }
            break;
          default:
            for (uint64_t i = b0; i < b1; i++, src += record_size) {
              std::memcpy(dst, src, sz);
              dst += sz;
            }
        }
      }
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t nt = std::min<uint64_t>(
      nthreads > 0 ? (uint64_t)nthreads : (hw ? hw : 1),
      std::max<uint64_t>(n / (4 * block), 1));
  if (nt <= 1) {
    do_range(0, n);
    return;
  }
  std::vector<std::thread> pool;
  // block-aligned split so two threads never share an output cache line
  uint64_t per = ((n + nt - 1) / nt + block - 1) / block * block;
  for (uint64_t t = 0; t < nt; t++) {
    uint64_t lo = t * per, hi = std::min(lo + per, n);
    if (lo >= hi) break;
    pool.emplace_back(do_range, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// Decode contiguous (n, 3) i32 LAS locals to (n, 3) f64 world positions
// (pos*scale + offset, raw_readers.rs:39-50) — the converting-read hot
// transform, threaded.
void laz_decode_positions(const int32_t* local, uint64_t n,
                          const double* scale, const double* offset,
                          double* out, int nthreads) {
  double sx = scale[0], sy = scale[1], sz = scale[2];
  double ox = offset[0], oy = offset[1], oz = offset[2];
  auto do_range = [&](uint64_t lo, uint64_t hi) {
    const int32_t* p = local + lo * 3;
    double* q = out + lo * 3;
    for (uint64_t i = lo; i < hi; i++) {
      q[0] = (double)p[0] * sx + ox;
      q[1] = (double)p[1] * sy + oy;
      q[2] = (double)p[2] * sz + oz;
      p += 3;
      q += 3;
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t nt = std::min<uint64_t>(
      nthreads > 0 ? (uint64_t)nthreads : (hw ? hw : 1),
      std::max<uint64_t>(n / 65536, 1));
  if (nt <= 1) {
    do_range(0, n);
    return;
  }
  std::vector<std::thread> pool;
  uint64_t per = (n + nt - 1) / nt;
  for (uint64_t t = 0; t < nt; t++) {
    uint64_t lo = t * per, hi = std::min(lo + per, n);
    if (lo >= hi) break;
    pool.emplace_back(do_range, lo, hi);
  }
  for (auto& th : pool) th.join();
}

int laz_selftest() {
  // stage 1: bit model
  {
    Encoder enc;
    enc.init();
    ArithmeticBitModel bm;
    bm.init();
    U32 bits[101];
    for (int i = 0; i < 101; i++) bits[i] = (i * 7 + i / 3) % 2;
    for (int i = 0; i < 101; i++) enc.encodeBit(bm, bits[i]);
    enc.done();
    Decoder dec;
    dec.buf = enc.out.data();
    dec.pos = 0;
    dec.size = enc.out.size();
    dec.init();
    ArithmeticBitModel bm2;
    bm2.init();
    for (int i = 0; i < 101; i++)
      if (dec.decodeBit(bm2) != bits[i]) return -101;
  }
  // stage 2: symbol models (small = linear search, large = decoder table)
  for (U32 nsym : {5u, 14u, 64u, 256u}) {
    Encoder enc;
    enc.init();
    ArithmeticModel m;
    m.init(nsym, true);
    U32 syms[257];
    for (U32 i = 0; i < 257; i++) syms[i] = (i * 31 + (i >> 2)) % nsym;
    for (U32 i = 0; i < 257; i++) enc.encodeSymbol(m, syms[i]);
    enc.done();
    Decoder dec;
    dec.buf = enc.out.data();
    dec.pos = 0;
    dec.size = enc.out.size();
    dec.init();
    ArithmeticModel m2;
    m2.init(nsym, false);
    for (U32 i = 0; i < 257; i++)
      if (dec.decodeSymbol(m2) != syms[i]) return -(200 + int(nsym));
  }
  // stage 3: raw bits
  {
    Encoder enc;
    enc.init();
    for (U32 i = 0; i < 64; i++) {
      enc.writeBits(13, (i * 2654435761u) & 0x1FFF);
      enc.writeInt(i * 2654435761u);
    }
    enc.done();
    Decoder dec;
    dec.buf = enc.out.data();
    dec.pos = 0;
    dec.size = enc.out.size();
    dec.init();
    for (U32 i = 0; i < 64; i++) {
      if (dec.readBits(13) != ((i * 2654435761u) & 0x1FFF)) return -301;
      if (dec.readInt() != i * 2654435761u) return -302;
    }
  }
  // stage 4: integer codec
  {
    Encoder enc;
    enc.init();
    IntegerCodec ic;
    ic.setup(32, 2);
    ic.initModels(true);
    I32 vals[300];
    I32 preds[300];
    for (int i = 0; i < 300; i++) {
      preds[i] = (i * 977) % 5000 - 2500;
      I32 d = ((i * 13931) % 200000) - 100000;
      if (i % 17 == 0) d = 0;
      if (i % 23 == 0) d = INT32_MIN + 5;
      vals[i] = preds[i] + d;
    }
    for (int i = 0; i < 300; i++)
      ic.compress(enc, preds[i], vals[i], i % 2);
    enc.done();
    Decoder dec;
    dec.buf = enc.out.data();
    dec.pos = 0;
    dec.size = enc.out.size();
    dec.init();
    IntegerCodec ic2;
    ic2.setup(32, 2);
    ic2.initModels(false);
    for (int i = 0; i < 300; i++)
      if (ic2.decompress(dec, preds[i], i % 2) != vals[i]) return -401;
  }
  // stage 5: ic with 16 bits (wrap-around behaviour)
  {
    Encoder enc;
    enc.init();
    IntegerCodec ic;
    ic.setup(16, 1);
    ic.initModels(true);
    I32 vals[200], preds[200];
    for (int i = 0; i < 200; i++) {
      preds[i] = (i * 7919) % 65536;
      vals[i] = (preds[i] + (i * 31) - 300) & 0xFFFF;
    }
    for (int i = 0; i < 200; i++) ic.compress(enc, preds[i], vals[i], 0);
    enc.done();
    Decoder dec;
    dec.buf = enc.out.data();
    dec.pos = 0;
    dec.size = enc.out.size();
    dec.init();
    IntegerCodec ic2;
    ic2.setup(16, 1);
    ic2.initModels(false);
    for (int i = 0; i < 200; i++) {
      I32 r = ic2.decompress(dec, preds[i], 0);
      if (U16(r) != U16(vals[i])) return -501;
    }
  }
  return 0;
}

// Debug/introspection helper: decode the chunk table into `sizes_out`
// (capacity `max_chunks`).  Returns number of chunks or negative error.
int laz_chunk_sizes(const uint8_t* file, uint64_t file_len,
                    uint64_t point_data_offset, uint32_t* sizes_out,
                    uint32_t max_chunks) {
  if (point_data_offset + 8 > file_len) return -1;
  I64 table_off;
  std::memcpy(&table_off, file + point_data_offset, 8);
  if (table_off < 0 || U64(table_off) + 8 > file_len) return -3;
  U32 version, number_chunks;
  std::memcpy(&version, file + table_off, 4);
  std::memcpy(&number_chunks, file + table_off + 4, 4);
  if (number_chunks > max_chunks) return -4;
  Decoder dec;
  dec.buf = file;
  dec.pos = size_t(table_off) + 8;
  dec.size = file_len;
  dec.init();
  IntegerCodec ic;
  ic.setup(32, 2);
  ic.initModels(false);
  for (U32 i = 0; i < number_chunks; i++) {
    sizes_out[i] = U32(ic.decompress(dec, i ? I32(sizes_out[i - 1]) : 0, 1));
  }
  return int(number_chunks);
}


// Fused converting read: ONE pass over the wire records that emits the
// f64 world positions (i32*scale+offset, raw_readers.rs:39-50), the
// unpacked flag columns (basic u8 / extended u16 bitfields,
// raw_readers.rs:59-118) and every pass-through column.  Replaces the
// deinterleave pass + the separate position-decode pass + the numpy
// flag fan-out of the converting-read path: the record bytes are hot in
// cache exactly once.  Parallel over row blocks like laz_deinterleave.
void laz_las_convert(const uint8_t* records, uint64_t n,
                     uint32_t record_size, uint32_t pos_offset,
                     const double* scale, const double* offset,
                     double* pos_out, uint32_t flags_offset,
                     int flags_mode, uint8_t* const* flag_outs,
                     const uint32_t* f_offs, const uint32_t* f_sizes,
                     uint32_t n_fields, uint8_t* const* f_outs,
                     int nthreads) {
  const uint64_t block = 4096;
  double sx = scale ? scale[0] : 0, sy = scale ? scale[1] : 0,
         sz = scale ? scale[2] : 0;
  double ox = offset ? offset[0] : 0, oy = offset ? offset[1] : 0,
         oz = offset ? offset[2] : 0;
  auto do_range = [&](uint64_t lo, uint64_t hi) {
    // local copies: stores through the (char-aliasing) output pointers
    // must not force reloads of the scale factors each iteration
    const double lsx = sx, lsy = sy, lsz = sz;
    const double lox = ox, loy = oy, loz = oz;
    const uint32_t rs = record_size;
    for (uint64_t b0 = lo; b0 < hi; b0 += block) {
      uint64_t b1 = std::min(b0 + block, hi);
      if (pos_out) {
        const uint8_t* __restrict src = records + b0 * rs + pos_offset;
        double* __restrict q = pos_out + b0 * 3;
        for (uint64_t i = b0; i < b1; i++, src += rs) {
          int32_t x, y, z;
          std::memcpy(&x, src, 4);
          std::memcpy(&y, src + 4, 4);
          std::memcpy(&z, src + 8, 4);
          q[0] = (double)x * lsx + lox;
          q[1] = (double)y * lsy + loy;
          q[2] = (double)z * lsz + loz;
          q += 3;
        }
      }
      if (flags_mode == 1) {  // basic u8: rn 0-2, nr 3-5, dir 6, edge 7
        const uint8_t* src = records + b0 * record_size + flags_offset;
        uint8_t* o0 = flag_outs[0] ? flag_outs[0] + b0 : nullptr;
        uint8_t* o1 = flag_outs[1] ? flag_outs[1] + b0 : nullptr;
        uint8_t* o2 = flag_outs[2] ? flag_outs[2] + b0 : nullptr;
        uint8_t* o3 = flag_outs[3] ? flag_outs[3] + b0 : nullptr;
        for (uint64_t i = b0; i < b1; i++, src += record_size) {
          uint8_t f = *src;
          if (o0) *o0++ = f & 0x7;
          if (o1) *o1++ = (f >> 3) & 0x7;
          if (o2) *o2++ = (f >> 6) & 0x1;
          if (o3) *o3++ = (f >> 7) & 0x1;
        }
      } else if (flags_mode == 2) {  // extended u16
        const uint8_t* src = records + b0 * record_size + flags_offset;
        uint8_t* o0 = flag_outs[0] ? flag_outs[0] + b0 : nullptr;
        uint8_t* o1 = flag_outs[1] ? flag_outs[1] + b0 : nullptr;
        uint8_t* o2 = flag_outs[2] ? flag_outs[2] + b0 : nullptr;
        uint8_t* o3 = flag_outs[3] ? flag_outs[3] + b0 : nullptr;
        uint8_t* o4 = flag_outs[4] ? flag_outs[4] + b0 : nullptr;
        uint8_t* o5 = flag_outs[5] ? flag_outs[5] + b0 : nullptr;
        for (uint64_t i = b0; i < b1; i++, src += record_size) {
          uint16_t f;
          std::memcpy(&f, src, 2);
          if (o0) *o0++ = f & 0xF;          // ReturnNumber
          if (o1) *o1++ = (f >> 4) & 0xF;   // NumberOfReturns
          if (o2) *o2++ = (f >> 8) & 0xF;   // ClassificationFlags
          if (o3) *o3++ = (f >> 12) & 0x3;  // ScannerChannel
          if (o4) *o4++ = (f >> 14) & 0x1;  // ScanDirectionFlag
          if (o5) *o5++ = (f >> 15) & 0x1;  // EdgeOfFlightLine
        }
      }
      for (uint32_t f = 0; f < n_fields; f++) {
        const uint8_t* src = records + b0 * record_size + f_offs[f];
        uint32_t szf = f_sizes[f];
        uint8_t* dst = f_outs[f] + b0 * szf;
        switch (szf) {
          case 1:
            for (uint64_t i = b0; i < b1; i++, src += record_size)
              *dst++ = *src;
            break;
          case 2:
            for (uint64_t i = b0; i < b1; i++, src += record_size) {
              uint16_t v; std::memcpy(&v, src, 2);
              std::memcpy(dst, &v, 2); dst += 2;
            }
            break;
          case 4:
            for (uint64_t i = b0; i < b1; i++, src += record_size) {
              uint32_t v; std::memcpy(&v, src, 4);
              std::memcpy(dst, &v, 4); dst += 4;
            }
            break;
          case 8:
            for (uint64_t i = b0; i < b1; i++, src += record_size) {
              uint64_t v; std::memcpy(&v, src, 8);
              std::memcpy(dst, &v, 8); dst += 8;
            }
            break;
          default:
            for (uint64_t i = b0; i < b1; i++, src += record_size) {
              std::memcpy(dst, src, szf); dst += szf;
            }
        }
      }
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t nt = std::min<uint64_t>(
      nthreads > 0 ? (uint64_t)nthreads : (hw ? hw : 1),
      std::max<uint64_t>(n / (4 * block), 1));
  if (nt <= 1) { do_range(0, n); return; }
  std::vector<std::thread> pool;
  uint64_t per = ((n + nt - 1) / nt + block - 1) / block * block;
  for (uint64_t t = 0; t < nt; t++) {
    uint64_t lo = t * per, hi = std::min(lo + per, n);
    if (lo >= hi) break;
    pool.emplace_back(do_range, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
