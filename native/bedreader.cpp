// Native PLINK .bed decoder for bayesrrcpp_tpu.
//
// Native equivalent of the reference's data-ingestion path (the
// reference takes a dense in-RAM R matrix, src/BayesRv2.cpp:60, so it tops
// out at host RAM; real genotype data ships as PLINK 2-bit .bed).  This
// decoder streams SNP-major .bed bytes straight into the sampler's packed
// 2-bit word layout (16 dosage codes per int32 word, code j at bits 2j --
// see models/bayesr.py::_quantize_packed) and computes the per-marker
// standardization stats (missing-aware mean / ddof-1 sd) in the same pass,
// so a biobank-scale matrix never exists in dense form on the host:
// 0.25 bytes/genotype in, 0.25 bytes/genotype out.
//
// PLINK code -> dosage-code mapping (io/bed.py::_DOSAGE convention):
//   00 (hom A1) -> 2,  01 (missing) -> 3 (= MISSING_CODE),
//   10 (het)    -> 1,  11 (hom A2)  -> 0.
//
// Byte-level LUTs process 4 genotypes per step; markers are embarrassingly
// parallel (SNP-major rows are contiguous) and split across threads.
// Exposed as a C ABI consumed via ctypes (io/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t kCodeMap[4] = {2, 3, 1, 0};

struct ByteLuts {
  uint8_t map[256];   // byte with all 4 plink codes remapped to dosage codes
  uint8_t sum[256];   // sum of dosages over non-missing codes (<= 8)
  uint8_t sq[256];    // sum of squared dosages (<= 16)
  uint8_t miss[256];  // number of missing codes (<= 4)
};

ByteLuts MakeLuts() {
  ByteLuts l{};
  for (int b = 0; b < 256; ++b) {
    uint8_t mapped = 0, s = 0, q = 0, mi = 0;
    for (int j = 0; j < 4; ++j) {
      int code = (b >> (2 * j)) & 3;
      uint8_t d = kCodeMap[code];
      mapped |= static_cast<uint8_t>(d << (2 * j));
      if (d == 3) {
        ++mi;
      } else {
        s += d;
        q += d * d;
      }
    }
    l.map[b] = mapped;
    l.sum[b] = s;
    l.sq[b] = q;
    l.miss[b] = mi;
  }
  return l;
}

const ByteLuts kLut = MakeLuts();

void DecodeRange(const uint8_t* bed, int64_t m0, int64_t m1, int64_t n,
                 int64_t bpm, int32_t* words, int64_t wpad, double* means,
                 double* sds, int64_t* miss_counts) {
  const int64_t full_bytes = n / 4;
  const int rem = static_cast<int>(n % 4);
  const int64_t out_bytes = wpad * 4;
  for (int64_t m = m0; m < m1; ++m) {
    const uint8_t* in = bed + m * bpm;
    uint8_t* out = reinterpret_cast<uint8_t*>(words + m * wpad);
    int64_t s = 0, q = 0, mi = 0;
    for (int64_t b = 0; b < full_bytes; ++b) {
      const uint8_t v = in[b];
      out[b] = kLut.map[v];
      s += kLut.sum[v];
      q += kLut.sq[v];
      mi += kLut.miss[v];
    }
    int64_t used = full_bytes;
    if (rem) {
      // trailing partial byte: PLINK pads unused slots with 00 (which would
      // map to dosage 2); decode only the valid slots, zero the rest
      const uint8_t v = in[full_bytes];
      uint8_t partial = 0;
      for (int j = 0; j < rem; ++j) {
        const uint8_t d = kCodeMap[(v >> (2 * j)) & 3];
        partial |= static_cast<uint8_t>(d << (2 * j));
        if (d == 3) {
          ++mi;
        } else {
          s += d;
          q += d * d;
        }
      }
      out[full_bytes] = partial;
      used = full_bytes + 1;
    }
    if (used < out_bytes) std::memset(out + used, 0, out_bytes - used);
    const int64_t cnt = n - mi;
    const double mean = cnt > 0 ? static_cast<double>(s) / cnt : 0.0;
    double var = 0.0;
    if (cnt > 1) {
      var = (static_cast<double>(q) - cnt * mean * mean) / (cnt - 1);
      if (var < 0.0) var = 0.0;
    }
    means[m] = mean;
    sds[m] = std::sqrt(var);
    miss_counts[m] = mi;
  }
}

}  // namespace

extern "C" {

// Decodes M SNP-major PLINK genotype rows (`bed` excludes the 3-byte
// header) into `words` (M x wpad int32, sampler 2-bit word layout, pad
// lanes zeroed) plus per-marker mean / sd (ddof=1, missing-aware) and
// missing counts.  Returns the total number of missing calls, or -1 on
// invalid arguments.
long long bed_decode_packed(const uint8_t* bed, long long m_markers,
                            long long n_individuals, int32_t* words,
                            long long wpad, double* means, double* sds,
                            long long* miss_counts, int n_threads) {
  if (m_markers < 0 || n_individuals <= 0 || wpad * 16 < n_individuals)
    return -1;
  const int64_t bpm = (n_individuals + 3) / 4;
  int nt = n_threads > 0 ? n_threads
                         : static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > m_markers) nt = static_cast<int>(m_markers > 0 ? m_markers : 1);
  auto miss64 = reinterpret_cast<int64_t*>(miss_counts);
  if (nt == 1) {
    DecodeRange(bed, 0, m_markers, n_individuals, bpm, words, wpad, means,
                sds, miss64);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    const int64_t per = (m_markers + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      const int64_t lo = t * per;
      const int64_t hi = std::min<int64_t>(lo + per, m_markers);
      if (lo >= hi) break;
      threads.emplace_back(DecodeRange, bed, lo, hi, n_individuals, bpm,
                           words, wpad, means, sds, miss64);
    }
    for (auto& th : threads) th.join();
  }
  long long total = 0;
  for (int64_t m = 0; m < m_markers; ++m) total += miss64[m];
  return total;
}

}  // extern "C"
