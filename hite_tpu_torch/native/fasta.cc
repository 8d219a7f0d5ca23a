// Native host runtime: fast FASTA parsing + interval algebra.
//
// The reference's IO layer is pure-Python dict-of-strings FASTA parsing
// (`module/Util.py:1650/1983`) which is the host-side bottleneck for
// GB-scale genomes.  This library memory-maps the file, encodes bases to
// the framework's uint8 codes (A0 C1 G2 T3 other 4) in one pass, and
// exposes a C ABI consumed via ctypes (hite_tpu_torch/native/runtime.py).
//
// Built by hite_tpu_torch/kernels.py with g++ into _build/libfasta.so.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <vector>

namespace {

struct FastaResult {
  uint8_t* codes;        // concatenated sequence codes
  int64_t* seq_offsets;  // n_seqs + 1 offsets into codes
  char* names;           // '\0'-joined names
  int64_t* name_offsets; // n_seqs + 1 offsets into names
  int64_t n_seqs;
  int64_t total_len;
  int64_t names_len;
};

uint8_t g_lut[256];

struct LutInit {
  LutInit() {
    memset(g_lut, 4, sizeof(g_lut));
    g_lut[(unsigned)'A'] = 0; g_lut[(unsigned)'a'] = 0;
    g_lut[(unsigned)'C'] = 1; g_lut[(unsigned)'c'] = 1;
    g_lut[(unsigned)'G'] = 2; g_lut[(unsigned)'g'] = 2;
    g_lut[(unsigned)'T'] = 3; g_lut[(unsigned)'t'] = 3;
  }
} g_lut_init;

}  // namespace

extern "C" {

// Parse a FASTA file; returns 0 on success. Caller frees via fasta_free.
int fasta_read(const char* path, FastaResult** out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -2; }
  size_t size = (size_t)st.st_size;
  const char* data = nullptr;
  if (size > 0) {
    data = (const char*)mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (data == MAP_FAILED) { close(fd); return -3; }
  }

  std::vector<uint8_t> codes;
  codes.reserve(size);
  std::vector<int64_t> seq_offsets{0};
  std::vector<char> names;
  std::vector<int64_t> name_offsets{0};

  size_t i = 0;
  bool have_seq = false;
  while (i < size) {
    if (data[i] == '>') {
      if (have_seq) seq_offsets.push_back((int64_t)codes.size());
      have_seq = true;
      ++i;
      // name = first whitespace-separated token
      while (i < size && data[i] != '\n' && data[i] != ' ' &&
             data[i] != '\t' && data[i] != '\r') {
        names.push_back(data[i]);
        ++i;
      }
      names.push_back('\0');
      name_offsets.push_back((int64_t)names.size());
      while (i < size && data[i] != '\n') ++i;  // rest of header
      ++i;
    } else {
      while (i < size && data[i] != '\n') {
        unsigned char c = (unsigned char)data[i];
        if (c != '\r') codes.push_back(g_lut[c]);
        ++i;
      }
      ++i;
    }
  }
  if (have_seq) seq_offsets.push_back((int64_t)codes.size());

  if (data) munmap((void*)data, size);
  close(fd);

  auto* r = (FastaResult*)malloc(sizeof(FastaResult));
  r->n_seqs = (int64_t)seq_offsets.size() - 1;
  r->total_len = (int64_t)codes.size();
  r->names_len = (int64_t)names.size();
  r->codes = (uint8_t*)malloc(codes.size() ? codes.size() : 1);
  memcpy(r->codes, codes.data(), codes.size());
  r->seq_offsets = (int64_t*)malloc(seq_offsets.size() * sizeof(int64_t));
  memcpy(r->seq_offsets, seq_offsets.data(),
         seq_offsets.size() * sizeof(int64_t));
  r->names = (char*)malloc(names.size() ? names.size() : 1);
  memcpy(r->names, names.data(), names.size());
  r->name_offsets = (int64_t*)malloc(name_offsets.size() * sizeof(int64_t));
  memcpy(r->name_offsets, name_offsets.data(),
         name_offsets.size() * sizeof(int64_t));
  *out = r;
  return 0;
}

void fasta_free(FastaResult* r) {
  if (!r) return;
  free(r->codes);
  free(r->seq_offsets);
  free(r->names);
  free(r->name_offsets);
  free(r);
}

// Merge sorted-or-unsorted half-open intervals in place.
// starts/ends: int64 [n]; returns the merged count; results are written
// back into the first `count` slots of starts/ends.
int64_t intervals_merge(int64_t* starts, int64_t* ends, int64_t n,
                        int64_t gap) {
  if (n <= 0) return 0;
  // simple index sort by start
  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = i;
  std::sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
    return starts[a] < starts[b] || (starts[a] == starts[b] && ends[a] < ends[b]);
  });
  std::vector<int64_t> ms, me;
  ms.reserve(n); me.reserve(n);
  for (int64_t k = 0; k < n; ++k) {
    int64_t s = starts[idx[k]], e = ends[idx[k]];
    if (!ms.empty() && s <= me.back() + gap) {
      if (e > me.back()) me.back() = e;
    } else {
      ms.push_back(s);
      me.push_back(e);
    }
  }
  for (size_t k = 0; k < ms.size(); ++k) { starts[k] = ms[k]; ends[k] = me[k]; }
  return (int64_t)ms.size();
}

// Total bp of targets covered by the merged cover set (both half-open).
int64_t intervals_covered_bp(const int64_t* t_starts, const int64_t* t_ends,
                             int64_t nt, const int64_t* c_starts,
                             const int64_t* c_ends, int64_t nc) {
  int64_t total = 0;
  int64_t ci = 0;
  for (int64_t i = 0; i < nt; ++i) {
    int64_t s = t_starts[i], e = t_ends[i];
    // assumes both lists sorted by start and cover merged
    while (ci > 0 && c_ends[ci - 1] > s) --ci;  // rewind if needed
    for (int64_t j = ci; j < nc && c_starts[j] < e; ++j) {
      int64_t lo = s > c_starts[j] ? s : c_starts[j];
      int64_t hi = e < c_ends[j] ? e : c_ends[j];
      if (hi > lo) total += hi - lo;
      if (c_ends[j] <= s) ci = j + 1;
    }
  }
  return total;
}

}  // extern "C"
