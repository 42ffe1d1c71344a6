// External-memory fingerprint store: the host-side tier of the checker's
// dedup table, for the port's --fpstore-dir route.
//
// The port's copy of tla_raft_tpu/native/fpstore.cpp: the same code, the
// same C interface and the same on-disk run format (run_NNNNNN.fp, sorted
// unique little-endian u64), so the two packages' stores behave alike on
// the same streams.  TLC keeps its FPSet (the 64-bit fingerprint dedup
// table) in JVM heap and spills to its states/ metadir when it outgrows
// memory; here, when a run's visited set should not live on the card, this
// store takes it on the host: an LSM-style set of sorted immutable runs
// (one file per flushed batch, memory-mapped, each with an in-memory
// blocked bloom) over a sorted in-memory buffer, with batched membership
// queries (a binary search per run).
//
// Interface is plain C for ctypes.  Single-threaded by design: the engine
// calls it once per BFS level with large batches, so per-call overhead is
// amortized.
//
// Build (tla_raft_tpu_torch/native/__init__.py does it at first use, into
// build/native/<digest>/ under the repo root):
//   g++ -O2 -std=c++17 -shared -fPIC fpstore.cpp -o libfpstore.so

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Run {
  uint64_t* data = nullptr;  // mmap'd sorted unique fingerprints
  size_t n = 0;
  int fd = -1;
  std::string path;
  // per-run blocked bloom (ops/sieve.py's C++ twin: one u64 word per
  // block, 4 bits from disjoint 6-bit fields of a salted second mix).
  // Built in memory at write_run, never persisted: a reopened store
  // starts empty (resume rebuilds from the delta log), so the filter's
  // lifetime matches the mmap's.  No false negatives — a miss skips
  // the run's binary search outright.
  std::vector<uint64_t> bloom;
  uint64_t bloom_mask = 0;  // word-index mask (size - 1)
};

constexpr uint64_t kBloomSalt = 0x9E3779B97F4A7C15ull;
constexpr int kBloomBits = 4;

uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D9ECA592EAF335ull;
  return x ^ (x >> 31);
}

void bloom_word_mask(uint64_t fp, uint64_t& word, uint64_t& mask) {
  word = mix64(fp);
  uint64_t h2 = mix64(fp ^ kBloomSalt);
  mask = 0;
  for (int i = 0; i < kBloomBits; i++)
    mask |= 1ull << ((h2 >> (6 * i)) & 63);
}

void bloom_build(Run& r) {
  // ~8 bits/key design load (64-bit words, one word per 8 keys),
  // power-of-two so the block index is a mask; floored at 64 words
  size_t words = 64;
  while (words * 8 < r.n) words <<= 1;
  r.bloom.assign(words, 0);
  r.bloom_mask = words - 1;
  for (size_t i = 0; i < r.n; i++) {
    uint64_t w, m;
    bloom_word_mask(r.data[i], w, m);
    r.bloom[w & r.bloom_mask] |= m;
  }
}

bool bloom_maybe(const Run& r, uint64_t fp) {
  if (r.bloom.empty()) return true;  // no filter: must search
  uint64_t w, m;
  bloom_word_mask(fp, w, m);
  return (r.bloom[w & r.bloom_mask] & m) == m;
}

struct FPStore {
  std::string dir;
  size_t mem_budget;           // max in-memory buffer entries before spill
  std::vector<uint64_t> mem;   // sorted unique in-memory tier
  std::vector<Run> runs;       // on-disk sorted runs, newest last
  size_t total = 0;            // total unique fingerprints
  int next_run_id = 0;
  uint64_t bloom_skips = 0;    // run binary searches avoided by blooms
};

bool contains_sorted(const uint64_t* a, size_t n, uint64_t x) {
  const uint64_t* e = a + n;
  const uint64_t* it = std::lower_bound(a, e, x);
  return it != e && *it == x;
}

int write_run(FPStore* s, const std::vector<uint64_t>& v) {
  char name[64];
  std::snprintf(name, sizeof name, "/run_%06d.fp", s->next_run_id++);
  std::string path = s->dir + name;
  int fd = ::open(path.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  size_t bytes = v.size() * sizeof(uint64_t);
  if (::ftruncate(fd, (off_t)bytes) != 0) { ::close(fd); return -1; }
  void* p = ::mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (p == MAP_FAILED) { ::close(fd); return -1; }
  std::memcpy(p, v.data(), bytes);
  ::msync(p, bytes, MS_ASYNC);
  Run r;
  r.data = (uint64_t*)p;
  r.n = v.size();
  r.fd = fd;
  r.path = path;
  bloom_build(r);
  s->runs.push_back(std::move(r));
  return 0;
}

void drop_run(Run& r) {
  if (r.data) ::munmap(r.data, r.n * sizeof(uint64_t));
  if (r.fd >= 0) ::close(r.fd);
  ::unlink(r.path.c_str());
  r.data = nullptr;
}

// Merge every run + the memory tier into one run (k-way linear merge).
int compact(FPStore* s) {
  std::vector<uint64_t> merged;
  merged.reserve(s->total);
  std::vector<std::pair<const uint64_t*, const uint64_t*>> cursors;
  for (auto& r : s->runs) cursors.push_back({r.data, r.data + r.n});
  cursors.push_back({s->mem.data(), s->mem.data() + s->mem.size()});
  // simple k-way: repeatedly take the min cursor head
  while (true) {
    const uint64_t* best = nullptr;
    size_t bi = 0;
    for (size_t i = 0; i < cursors.size(); i++) {
      if (cursors[i].first < cursors[i].second &&
          (!best || *cursors[i].first < *best)) {
        best = cursors[i].first;
        bi = i;
      }
    }
    if (!best) break;
    if (merged.empty() || merged.back() != *best) merged.push_back(*best);
    cursors[bi].first++;
  }
  for (auto& r : s->runs) drop_run(r);
  s->runs.clear();
  s->mem.clear();
  s->total = merged.size();
  if (!merged.empty() && write_run(s, merged) != 0) return -1;
  return 0;
}

}  // namespace

extern "C" {

FPStore* fpstore_open(const char* dir, uint64_t mem_budget_entries) {
  auto* s = new FPStore;
  s->dir = dir;
  s->mem_budget = mem_budget_entries ? mem_budget_entries : (64u << 20) / 8;
  ::mkdir(dir, 0755);
  return s;
}

uint64_t fpstore_count(FPStore* s) { return s->total; }
uint64_t fpstore_num_runs(FPStore* s) { return s->runs.size(); }
uint64_t fpstore_bloom_skips(FPStore* s) { return s->bloom_skips; }

// For each query: out[i] = 1 if fps[i] already present, else 0.
// Does NOT insert.
void fpstore_contains(FPStore* s, const uint64_t* fps, uint64_t n,
                      uint8_t* out) {
  for (uint64_t i = 0; i < n; i++) {
    uint64_t x = fps[i];
    bool hit = contains_sorted(s->mem.data(), s->mem.size(), x);
    for (auto it = s->runs.rbegin(); !hit && it != s->runs.rend(); ++it) {
      if (!bloom_maybe(*it, x)) { s->bloom_skips++; continue; }
      hit = contains_sorted(it->data, it->n, x);
    }
    out[i] = hit ? 1 : 0;
  }
}

// Insert a batch; out[i] = 1 iff fps[i] was newly inserted (0 = duplicate).
// Returns the number of new fingerprints, or UINT64_MAX on I/O error.
uint64_t fpstore_insert(FPStore* s, const uint64_t* fps, uint64_t n,
                        uint8_t* out) {
  std::vector<uint64_t> fresh;
  fresh.reserve(n);
  uint64_t added = 0;
  for (uint64_t i = 0; i < n; i++) {
    uint64_t x = fps[i];
    bool hit = contains_sorted(s->mem.data(), s->mem.size(), x);
    for (auto it = s->runs.rbegin(); !hit && it != s->runs.rend(); ++it) {
      if (!bloom_maybe(*it, x)) { s->bloom_skips++; continue; }
      hit = contains_sorted(it->data, it->n, x);
    }
    if (out) out[i] = hit ? 0 : 1;
    if (!hit) fresh.push_back(x);
  }
  // dedup the fresh batch (duplicates inside one call)
  std::sort(fresh.begin(), fresh.end());
  std::vector<uint64_t> uniq;
  uniq.reserve(fresh.size());
  for (uint64_t x : fresh)
    if (uniq.empty() || uniq.back() != x) uniq.push_back(x);
  // fix out[] for intra-batch duplicates: recount via membership of uniq
  if (out && uniq.size() != fresh.size()) {
    std::vector<uint64_t> seen;
    seen.reserve(fresh.size());
    for (uint64_t i = 0; i < n; i++) {
      if (!out[i]) continue;
      uint64_t x = fps[i];
      if (std::binary_search(seen.begin(), seen.end(), x)) {
        out[i] = 0;
      } else {
        seen.insert(std::lower_bound(seen.begin(), seen.end(), x), x);
      }
    }
  }
  added = uniq.size();
  // merge into the memory tier
  std::vector<uint64_t> merged;
  merged.reserve(s->mem.size() + uniq.size());
  std::merge(s->mem.begin(), s->mem.end(), uniq.begin(), uniq.end(),
             std::back_inserter(merged));
  s->mem.swap(merged);
  s->total += added;
  if (s->mem.size() >= s->mem_budget) {
    if (write_run(s, s->mem) != 0) return ~0ull;
    s->mem.clear();
    if (s->runs.size() > 16 && compact(s) != 0) return ~0ull;
  }
  return added;
}

int fpstore_compact(FPStore* s) { return compact(s); }

void fpstore_close(FPStore* s) {
  for (auto& r : s->runs) drop_run(r);
  delete s;
}

}  // extern "C"
