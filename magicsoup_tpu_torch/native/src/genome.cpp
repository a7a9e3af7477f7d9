// Native genome engine: genome->proteome translation, point mutations,
// and recombinations over flat byte buffers.
//
// This is the TPU-framework counterpart of the reference's Rust cdylib
// (rust/genetics.rs, rust/mutations.rs in mRcSchwering/magic-soup): the
// heavy string work stays on host, parallelized with OpenMP threads, and
// results are emitted as dense arrays that feed the JAX device path
// directly.  Exposed through a plain C ABI consumed via ctypes
// (magicsoup_tpu_torch/native/engine.py); all buffers crossing the boundary are
// caller-owned or allocated here and released with ms_free.
//
// Translation algorithm parity (rust/genetics.rs:13-123):
//  - per-reading-frame start stacks; a stop codon pops ALL pending starts
//    of its frame (nested/overlapping CDSs), emitting those >= min_cds_size
//  - domain extraction walks each CDS; on a domain-type match it reads
//    3 one-codon tokens + 1 two-codon token and jumps dom_size nts,
//    otherwise advances one codon
//  - proteins with only regulatory domains are discarded
// Mutation parity (rust/mutations.rs:11-154): Poisson(p*len) mutation
// counts, distinct sorted positions, indel offset tracking; recombination
// via strand-break fragments, shuffle, random split.  RNG here is seeded
// per sequence (seed, index) for reproducibility -- the reference uses
// thread-local OS RNG and is not reproducible.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr int CODON = 3;

// nucleotide byte -> 2-bit code, order TCGA (matches ALL_NTS); non-TCGA
// bytes map to -1 so codons containing them match nothing (parity with
// the Python fallback engine's sentinel handling)
int8_t NT_CODE[256];
struct NtCodeInit {
  NtCodeInit() {
    std::memset(NT_CODE, -1, sizeof(NT_CODE));
    NT_CODE[(unsigned char)'T'] = 0;
    NT_CODE[(unsigned char)'C'] = 1;
    NT_CODE[(unsigned char)'G'] = 2;
    NT_CODE[(unsigned char)'A'] = 3;
  }
} nt_code_init;

char COMPLEMENT[256];
struct ComplementInit {
  ComplementInit() {
    for (int i = 0; i < 256; ++i) COMPLEMENT[i] = (char)i;
    COMPLEMENT[(unsigned char)'A'] = 'T';
    COMPLEMENT[(unsigned char)'T'] = 'A';
    COMPLEMENT[(unsigned char)'C'] = 'G';
    COMPLEMENT[(unsigned char)'G'] = 'C';
  }
} complement_init;

// codon code (base-4 over 3 nts) at every position i of seq
void codon_codes(const char* seq, int64_t n, std::vector<int32_t>& out) {
  out.clear();
  if (n < CODON) return;
  out.resize(n - CODON + 1);
  for (int64_t i = 0; i + CODON <= n; ++i) {
    int c0 = NT_CODE[(unsigned char)seq[i]];
    int c1 = NT_CODE[(unsigned char)seq[i + 1]];
    int c2 = NT_CODE[(unsigned char)seq[i + 2]];
    out[i] = (c0 < 0 || c1 < 0 || c2 < 0) ? -1 : c0 * 16 + c1 * 4 + c2;
  }
}

struct Cds {
  int64_t start;
  int64_t stop;
  uint8_t is_fwd;
};

// per-frame start stacks; stop pops all pending starts of its frame
void coding_regions(const std::vector<int32_t>& codes,
                    const uint8_t* codon_flags, int min_cds, uint8_t is_fwd,
                    std::vector<Cds>& out) {
  std::vector<int64_t> starts[3];
  for (int f = 0; f < 3; ++f) starts[f].reserve(12);
  const int64_t n = (int64_t)codes.size();
  for (int64_t i = 0; i < n; ++i) {
    if (codes[i] < 0) continue;
    uint8_t flag = codon_flags[codes[i]];
    if (flag == 0) continue;
    int frame = (int)(i % CODON);
    if (flag == 1) {
      starts[frame].push_back(i);
    } else {
      int64_t j = i + CODON;
      while (!starts[frame].empty()) {
        int64_t d = starts[frame].back();
        starts[frame].pop_back();
        if (j - d >= min_cds) out.push_back({d, j, is_fwd});
      }
    }
  }
}

// per-genome result buffers
struct GenomeResult {
  std::vector<int32_t> prots;  // rows of 4: cds_start, cds_end, is_fwd, n_doms
  std::vector<int32_t> doms;   // rows of 7: dt, i0, i1, i2, i3, start, end
  int32_t n_prots = 0;
};

void extract_domains(const std::vector<int32_t>& codes,
                     const std::vector<Cds>& cdss, int dom_size,
                     int dom_type_size, const uint8_t* dom_type_lut,
                     const int32_t* one_codon_lut,
                     const int32_t* two_codon_lut, GenomeResult& res) {
  const int64_t n_codes = (int64_t)codes.size();
  std::vector<int32_t> my_doms;
  for (const Cds& cds : cdss) {
    int64_t n = cds.stop - cds.start;
    int64_t i = 0;
    bool useful = false;
    my_doms.clear();
    while (i + dom_size <= n) {
      int64_t dom_start = cds.start + i;
      int32_t type_code = 0;
      bool in_range = true;
      for (int k = 0; k < dom_type_size; k += CODON) {
        int64_t p = dom_start + k;
        if (p >= n_codes || codes[p] < 0) {
          in_range = false;
          break;
        }
        type_code = type_code * 64 + codes[p];
      }
      uint8_t dom_type = in_range ? dom_type_lut[type_code] : 0;
      if (dom_type != 0) {
        if (dom_type != 3) useful = true;
        int64_t spec = dom_start + dom_type_size;
        auto tok1 = [&](int64_t p) -> int32_t {
          return codes[p] >= 0 ? one_codon_lut[codes[p]] : 0;
        };
        int32_t i0 = tok1(spec);
        int32_t i1 = tok1(spec + CODON);
        int32_t i2 = tok1(spec + 2 * CODON);
        int32_t c3a = codes[spec + 3 * CODON];
        int32_t c3b = codes[spec + 4 * CODON];
        int32_t i3 = (c3a >= 0 && c3b >= 0) ? two_codon_lut[c3a * 64 + c3b] : 0;
        int32_t row[7] = {(int32_t)dom_type, i0,
                          i1,                i2,
                          i3,                (int32_t)i,
                          (int32_t)(i + dom_size)};
        my_doms.insert(my_doms.end(), row, row + 7);
        i += dom_size;
      } else {
        i += CODON;
      }
    }
    if (useful) {
      int32_t prow[4] = {(int32_t)cds.start, (int32_t)cds.stop,
                         (int32_t)cds.is_fwd,
                         (int32_t)(my_doms.size() / 7)};
      res.prots.insert(res.prots.end(), prow, prow + 4);
      res.doms.insert(res.doms.end(), my_doms.begin(), my_doms.end());
      res.n_prots += 1;
    }
  }
}

}  // namespace

extern "C" {

void ms_free(void* ptr) { std::free(ptr); }

// Translate n genomes (concatenated bytes + n+1 offsets).  Writes per-genome
// protein counts to prot_counts (caller-allocated, n entries) and allocates
// *out_prots (rows of 4) and *out_doms (rows of 7); row counts via
// *out_n_prots / *out_n_doms.  Caller frees with ms_free.
void ms_translate_genomes(const char* data, const int64_t* offsets, int64_t n,
                          const uint8_t* codon_flags,
                          const uint8_t* dom_type_lut,
                          const int32_t* one_codon_lut,
                          const int32_t* two_codon_lut, int dom_size,
                          int dom_type_size, int n_threads,
                          int32_t* prot_counts, int32_t** out_prots,
                          int64_t* out_n_prots, int32_t** out_doms,
                          int64_t* out_n_doms) {
  std::vector<GenomeResult> results((size_t)n);

#if defined(_OPENMP)
  if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel
#endif
  {
    std::vector<int32_t> codes;
    std::vector<Cds> cdss;
    std::string revcomp;
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 8)
#endif
    for (int64_t gi = 0; gi < n; ++gi) {
      const char* seq = data + offsets[gi];
      int64_t len = offsets[gi + 1] - offsets[gi];
      GenomeResult& res = results[gi];

      cdss.clear();
      codon_codes(seq, len, codes);
      coding_regions(codes, codon_flags, dom_size, 1, cdss);
      extract_domains(codes, cdss, dom_size, dom_type_size, dom_type_lut,
                      one_codon_lut, two_codon_lut, res);

      revcomp.resize((size_t)len);
      for (int64_t i = 0; i < len; ++i)
        revcomp[len - 1 - i] = COMPLEMENT[(unsigned char)seq[i]];
      cdss.clear();
      codon_codes(revcomp.data(), len, codes);
      coding_regions(codes, codon_flags, dom_size, 0, cdss);
      extract_domains(codes, cdss, dom_size, dom_type_size, dom_type_lut,
                      one_codon_lut, two_codon_lut, res);
    }
  }

  int64_t total_prots = 0, total_doms = 0;
  for (int64_t gi = 0; gi < n; ++gi) {
    prot_counts[gi] = results[gi].n_prots;
    total_prots += (int64_t)(results[gi].prots.size() / 4);
    total_doms += (int64_t)(results[gi].doms.size() / 7);
  }

  int32_t* prots =
      (int32_t*)std::malloc(sizeof(int32_t) * std::max<int64_t>(1, total_prots * 4));
  int32_t* doms =
      (int32_t*)std::malloc(sizeof(int32_t) * std::max<int64_t>(1, total_doms * 7));
  int64_t pi = 0, di = 0;
  for (int64_t gi = 0; gi < n; ++gi) {
    const GenomeResult& res = results[gi];
    std::memcpy(prots + pi, res.prots.data(), res.prots.size() * sizeof(int32_t));
    std::memcpy(doms + di, res.doms.data(), res.doms.size() * sizeof(int32_t));
    pi += (int64_t)res.prots.size();
    di += (int64_t)res.doms.size();
  }
  *out_prots = prots;
  *out_n_prots = total_prots;
  *out_doms = doms;
  *out_n_doms = total_doms;
}

// Pack flat translation buffers into the padded dense token tensor
// (b, p_cap, d_cap, 5) int16 [dom_type, i0, i1, i2, i3] consumed by the
// jitted parameter assembly — the native counterpart of the numpy scatter
// in ops/params.flat_to_dense.  out_dense is caller-allocated and
// ZEROED (b * p_cap * d_cap * 5 int16 entries); proteins/domains beyond
// the caps must not occur (the caller grows capacities per batch first).
void ms_pack_dense(const int32_t* prot_counts, int64_t b,
                   const int32_t* prots, int64_t n_prots,
                   const int32_t* doms, int64_t n_doms,
                   int64_t p_cap, int64_t d_cap, int n_threads,
                   int16_t* out_dense) {
  (void)n_doms;
  // per-genome protein row offsets (serial cumsum; b is small)
  std::vector<int64_t> prot_offs((size_t)b + 1, 0);
  for (int64_t gi = 0; gi < b; ++gi)
    prot_offs[(size_t)gi + 1] = prot_offs[(size_t)gi] + prot_counts[gi];
  // per-protein domain row offsets
  std::vector<int64_t> dom_offs((size_t)n_prots + 1, 0);
  for (int64_t pi = 0; pi < n_prots; ++pi)
    dom_offs[(size_t)pi + 1] = dom_offs[(size_t)pi] + prots[4 * pi + 3];

  const int64_t cell_stride = p_cap * d_cap * 5;
#if defined(_OPENMP)
  if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (int64_t gi = 0; gi < b; ++gi) {
    int16_t* cell = out_dense + gi * cell_stride;
    const int64_t p0 = prot_offs[(size_t)gi], p1 = prot_offs[(size_t)gi + 1];
    for (int64_t pi = p0; pi < p1; ++pi) {
      int16_t* prot = cell + (pi - p0) * d_cap * 5;
      const int64_t d0 = dom_offs[(size_t)pi], d1 = dom_offs[(size_t)pi + 1];
      for (int64_t di = d0; di < d1; ++di) {
        const int32_t* src = doms + 7 * di;
        int16_t* dst = prot + (di - d0) * 5;
        dst[0] = (int16_t)src[0];
        dst[1] = (int16_t)src[1];
        dst[2] = (int16_t)src[2];
        dst[3] = (int16_t)src[3];
        dst[4] = (int16_t)src[4];
      }
    }
  }
}

namespace {

const char MUT_NTS[4] = {'A', 'C', 'T', 'G'};

// distinct sorted positions in [0, len)
void sample_positions(std::mt19937_64& rng, int64_t len, int64_t k,
                      std::vector<int64_t>& out) {
  out.clear();
  if (k * 3 >= len) {
    // dense case: partial Fisher-Yates
    std::vector<int64_t> idx((size_t)len);
    for (int64_t i = 0; i < len; ++i) idx[i] = i;
    for (int64_t i = 0; i < k; ++i) {
      std::uniform_int_distribution<int64_t> d(i, len - 1);
      std::swap(idx[i], idx[d(rng)]);
    }
    out.assign(idx.begin(), idx.begin() + k);
  } else {
    // sparse case: rejection
    out.reserve((size_t)k);
    std::uniform_int_distribution<int64_t> d(0, len - 1);
    while ((int64_t)out.size() < k) {
      int64_t cand = d(rng);
      if (std::find(out.begin(), out.end(), cand) == out.end())
        out.push_back(cand);
    }
  }
  std::sort(out.begin(), out.end());
}

struct MutResult {
  std::string seq0;
  std::string seq1;  // only used by recombinations
  int64_t idx = -1;  // -1 = unchanged
};

}  // namespace

// Point mutations over n sequences.  Returns only mutated sequences:
// *out_data is the concatenation of the mutated sequences, *out_offsets has
// *out_n + 1 entries, *out_idxs maps each to its input index.
// The caller pre-draws the Poisson(p*len) mutation count per sequence
// (vectorized numpy on the host) and passes only sequences with >= 1
// mutation — this keeps the per-call work proportional to the number of
// actually-mutated sequences instead of the population size.
// orig_idxs holds each sequence's index in the caller's full population:
// RNG streams are keyed by it (not by the position within this call) so a
// genome's mutations don't depend on which other genomes were batched in.
void ms_point_mutations(const char* data, const int64_t* offsets, int64_t n,
                        const int64_t* n_muts_in, const int64_t* orig_idxs,
                        float p_indel, float p_del,
                        uint64_t seed, int n_threads, char** out_data,
                        int64_t** out_offsets, int64_t** out_idxs,
                        int64_t* out_n) {
  std::vector<MutResult> results((size_t)n);

#if defined(_OPENMP)
  if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel
#endif
  {
    std::vector<int64_t> positions;
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 64)
#endif
    for (int64_t si = 0; si < n; ++si) {
      const char* seq = data + offsets[si];
      int64_t len = offsets[si + 1] - offsets[si];
      if (len < 1) continue;
      std::mt19937_64 rng(seed * 1000003ULL + (uint64_t)orig_idxs[si]);
      int64_t n_muts = n_muts_in[si];
      if (n_muts < 1) continue;
      if (n_muts > len) n_muts = len;
      sample_positions(rng, len, n_muts, positions);

      std::string s(seq, (size_t)len);
      std::uniform_real_distribution<double> uni(0.0, 1.0);
      std::uniform_int_distribution<int> nt(0, 3);
      int64_t offset = 0;
      for (int64_t pos : positions) {
        int64_t cur = pos + offset;
        if (cur < 0) cur = 0;
        if (uni(rng) < (double)p_indel) {
          if (uni(rng) < (double)p_del) {
            if (cur >= (int64_t)s.size()) cur = (int64_t)s.size() - 1;
            s.erase((size_t)cur, 1);
            offset -= 1;
          } else {
            if (cur > (int64_t)s.size()) cur = (int64_t)s.size();
            s.insert((size_t)cur, 1, MUT_NTS[nt(rng)]);
            offset += 1;
          }
        } else {
          if (cur >= (int64_t)s.size()) cur = (int64_t)s.size() - 1;
          s[(size_t)cur] = MUT_NTS[nt(rng)];
        }
      }
      results[si].seq0 = std::move(s);
      results[si].idx = si;
    }
  }

  int64_t n_out = 0, total_len = 0;
  for (const MutResult& r : results) {
    if (r.idx >= 0) {
      n_out += 1;
      total_len += (int64_t)r.seq0.size();
    }
  }
  char* odata = (char*)std::malloc((size_t)std::max<int64_t>(1, total_len));
  int64_t* ooffs = (int64_t*)std::malloc(sizeof(int64_t) * (size_t)(n_out + 1));
  int64_t* oidxs =
      (int64_t*)std::malloc(sizeof(int64_t) * (size_t)std::max<int64_t>(1, n_out));
  int64_t w = 0, k = 0;
  ooffs[0] = 0;
  for (const MutResult& r : results) {
    if (r.idx < 0) continue;
    std::memcpy(odata + w, r.seq0.data(), r.seq0.size());
    w += (int64_t)r.seq0.size();
    oidxs[k] = r.idx;
    ooffs[++k] = w;
  }
  *out_data = odata;
  *out_offsets = ooffs;
  *out_idxs = oidxs;
  *out_n = n_out;
}

// Recombinations over n sequence pairs (2*n sequences concatenated:
// pair i = sequences 2i and 2i+1).  Output mirrors ms_point_mutations but
// with two sequences per result (2*out_n sequences, out_n indices).
void ms_recombinations(const char* data, const int64_t* offsets, int64_t n,
                       const int64_t* n_breaks_in, const int64_t* orig_idxs,
                       uint64_t seed,
                       int n_threads, char** out_data, int64_t** out_offsets,
                       int64_t** out_idxs, int64_t* out_n) {
  std::vector<MutResult> results((size_t)n);

#if defined(_OPENMP)
  if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel
#endif
  {
    std::vector<int64_t> positions;
    std::vector<std::pair<int64_t, int64_t>> parts;  // (global_start, len)
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 64)
#endif
    for (int64_t pi = 0; pi < n; ++pi) {
      const char* s0 = data + offsets[2 * pi];
      int64_t n0 = offsets[2 * pi + 1] - offsets[2 * pi];
      const char* s1 = data + offsets[2 * pi + 1];
      int64_t n1 = offsets[2 * pi + 2] - offsets[2 * pi + 1];
      int64_t n_both = n0 + n1;
      if (n_both < 1) continue;
      std::mt19937_64 rng(seed * 1000003ULL + (uint64_t)orig_idxs[pi]);
      int64_t n_muts = n_breaks_in[pi];
      if (n_muts < 1) continue;
      if (n_muts > n_both) n_muts = n_both;
      sample_positions(rng, n_both, n_muts, positions);

      // split both strands into fragments at the cut positions
      parts.clear();
      int64_t i = 0;
      for (int64_t j : positions) {
        if (j >= n0) break;
        parts.emplace_back(i, j - i);
        i = j;
      }
      parts.emplace_back(i, n0 - i);
      i = 0;
      for (int64_t j : positions) {
        if (j < n0) continue;
        parts.emplace_back(n0 + i, j - n0 - i);
        i = j - n0;
      }
      parts.emplace_back(n0 + i, n1 - i);

      std::shuffle(parts.begin(), parts.end(), rng);
      std::uniform_int_distribution<size_t> split(0, parts.size() - 1);
      size_t s = split(rng);

      MutResult& res = results[pi];
      res.seq0.reserve((size_t)n0);
      res.seq1.reserve((size_t)n1);
      auto frag = [&](size_t k) {
        int64_t g = parts[k].first;
        const char* src = g < n0 ? s0 + g : s1 + (g - n0);
        return std::string(src, (size_t)parts[k].second);
      };
      for (size_t k = 0; k < s; ++k) res.seq0 += frag(k);
      for (size_t k = s; k < parts.size(); ++k) res.seq1 += frag(k);
      res.idx = pi;
    }
  }

  int64_t n_out = 0, total_len = 0;
  for (const MutResult& r : results) {
    if (r.idx >= 0) {
      n_out += 1;
      total_len += (int64_t)(r.seq0.size() + r.seq1.size());
    }
  }
  char* odata = (char*)std::malloc((size_t)std::max<int64_t>(1, total_len));
  int64_t* ooffs =
      (int64_t*)std::malloc(sizeof(int64_t) * (size_t)(2 * n_out + 1));
  int64_t* oidxs =
      (int64_t*)std::malloc(sizeof(int64_t) * (size_t)std::max<int64_t>(1, n_out));
  int64_t w = 0, k = 0;
  ooffs[0] = 0;
  int64_t oi = 0;
  for (const MutResult& r : results) {
    if (r.idx < 0) continue;
    std::memcpy(odata + w, r.seq0.data(), r.seq0.size());
    w += (int64_t)r.seq0.size();
    ooffs[++k] = w;
    std::memcpy(odata + w, r.seq1.data(), r.seq1.size());
    w += (int64_t)r.seq1.size();
    ooffs[++k] = w;
    oidxs[oi++] = r.idx;
  }
  *out_data = odata;
  *out_offsets = ooffs;
  *out_idxs = oidxs;
  *out_n = n_out;
}

// Unique Moore-adjacent pairs among cell positions on the torus
// (counterpart of the reference's rust/world.rs:9-54 pairwise scan, done
// with an occupancy grid instead).  positions: (n, 2) int32 row-major.
// Output pairs (smaller index first) sorted ascending by (lo, hi) —
// identical order to the numpy fallback's encoded-unique.  Caller frees
// *out_pairs with ms_free.
void ms_neighbor_pairs(const int32_t* positions, int64_t n, int32_t map_size,
                       int32_t** out_pairs, int64_t* out_n) {
  const int64_t m = map_size;
  std::vector<int32_t> grid((size_t)(m * m), -1);
  for (int64_t i = 0; i < n; ++i) {
    grid[(size_t)(positions[2 * i] * m + positions[2 * i + 1])] = (int32_t)i;
  }
  static const int dx[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  static const int dy[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
  std::vector<int32_t> pairs;
  pairs.reserve((size_t)(n * 3));
  int32_t nb[8];
  for (int64_t i = 0; i < n; ++i) {
    const int64_t x = positions[2 * i], y = positions[2 * i + 1];
    size_t n_nb = 0;
    for (int k = 0; k < 8; ++k) {
      int64_t cx = x + dx[k], cy = y + dy[k];
      if (cx < 0) cx += m; else if (cx >= m) cx -= m;
      if (cy < 0) cy += m; else if (cy >= m) cy -= m;
      const int32_t cand = grid[(size_t)(cx * m + cy)];
      // emit each unordered pair once (from its smaller endpoint);
      // cand != i guards degenerate wraps at map_size <= 2
      if (cand > (int32_t)i) nb[n_nb++] = cand;
    }
    std::sort(nb, nb + n_nb);
    // degenerate maps can yield the same partner via several offsets
    for (size_t k = 0; k < n_nb; ++k) {
      if (k > 0 && nb[k] == nb[k - 1]) continue;
      pairs.push_back((int32_t)i);
      pairs.push_back(nb[k]);
    }
  }
  int32_t* out = (int32_t*)std::malloc(
      sizeof(int32_t) * std::max<size_t>(2, pairs.size()));
  std::memcpy(out, pairs.data(), sizeof(int32_t) * pairs.size());
  *out_pairs = out;
  *out_n = (int64_t)(pairs.size() / 2);
}

}  // extern "C"
