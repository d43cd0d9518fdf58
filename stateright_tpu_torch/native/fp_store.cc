// Native fingerprint store: the host-runtime half of the device checkers.
//
// The reference keeps its visited set / parent map in native concurrent
// hash maps (DashMap<Fingerprint, Option<Fingerprint>>,
// src/checker/bfs.rs:28-29). In this framework the *device*
// owns the visited set; what remains on the host is the parent-pointer map
// used for TLC-style path reconstruction and checkpointing — this file is
// its native implementation (open addressing over u64 fingerprints, batch
// ingestion straight from numpy buffers, chain walking in C).
//
// Keys are nonzero u64 fingerprints (0 is the empty-slot sentinel; device
// fingerprints are never (0,0) — see stateright_tpu_torch/ops/fingerprint.py).
// Parent 0 encodes "initial state". Single-writer use; readers may query
// between batch inserts (the Python side serializes access).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

struct Store {
  uint64_t *keys;     // 0 = empty
  uint64_t *parents;  // parallel to keys
  uint64_t capacity;  // power of two
  uint64_t size;
};

uint64_t hash_u64(uint64_t x) {
  // splitmix64 finalizer: well-mixed index bits from already-random keys.
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ULL;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebULL;
  x ^= x >> 31;
  return x;
}

uint64_t pow2ceil(uint64_t n) {
  uint64_t c = 1;
  while (c < n) c <<= 1;
  return c;
}

// Returns 0 on success, -1 on allocation failure (store left intact — the
// store holds every visited fingerprint, so exhausting host memory here is
// plausible and must surface as an error, not a segfault).
int grow(Store *s, uint64_t min_capacity) {
  uint64_t new_cap = s->capacity;
  while (new_cap < min_capacity || s->size * 10 >= new_cap * 7) new_cap <<= 1;
  uint64_t *nk = (uint64_t *)calloc(new_cap, sizeof(uint64_t));
  uint64_t *np = (uint64_t *)calloc(new_cap, sizeof(uint64_t));
  if (!nk || !np) {
    free(nk);
    free(np);
    return -1;
  }
  uint64_t mask = new_cap - 1;
  for (uint64_t i = 0; i < s->capacity; i++) {
    uint64_t k = s->keys[i];
    if (!k) continue;
    uint64_t j = hash_u64(k) & mask;
    while (nk[j]) j = (j + 1) & mask;
    nk[j] = k;
    np[j] = s->parents[i];
  }
  free(s->keys);
  free(s->parents);
  s->keys = nk;
  s->parents = np;
  s->capacity = new_cap;
  return 0;
}

// Returns the slot of key, or the empty slot where it would go.
uint64_t probe(const Store *s, uint64_t key) {
  uint64_t mask = s->capacity - 1;
  uint64_t j = hash_u64(key) & mask;
  while (s->keys[j] && s->keys[j] != key) j = (j + 1) & mask;
  return j;
}

}  // namespace

extern "C" {

// Returns NULL on allocation failure.
void *fps_new(uint64_t capacity_hint) {
  Store *s = (Store *)malloc(sizeof(Store));
  if (!s) return nullptr;
  s->capacity = pow2ceil(capacity_hint < 64 ? 64 : capacity_hint);
  s->keys = (uint64_t *)calloc(s->capacity, sizeof(uint64_t));
  s->parents = (uint64_t *)calloc(s->capacity, sizeof(uint64_t));
  if (!s->keys || !s->parents) {
    free(s->keys);
    free(s->parents);
    free(s);
    return nullptr;
  }
  s->size = 0;
  return s;
}

void fps_free(void *p) {
  Store *s = (Store *)p;
  free(s->keys);
  free(s->parents);
  free(s);
}

uint64_t fps_size(const void *p) { return ((const Store *)p)->size; }

// First-writer-wins batch insert (BFS: the first recorded parent is the
// shortest-path parent). Returns the number of new keys, or UINT64_MAX if
// growing the table failed (out of memory; no keys were inserted).
uint64_t fps_insert_batch(void *p, const uint64_t *children,
                          const uint64_t *parents, uint64_t n) {
  Store *s = (Store *)p;
  if ((s->size + n) * 10 >= s->capacity * 7) {
    if (grow(s, pow2ceil(s->size + n) * 2) != 0) return ~0ULL;
  }
  uint64_t fresh = 0;
  for (uint64_t i = 0; i < n; i++) {
    uint64_t key = children[i];
    if (!key) continue;
    uint64_t j = probe(s, key);
    if (!s->keys[j]) {
      s->keys[j] = key;
      s->parents[j] = parents ? parents[i] : 0;
      s->size++;
      fresh++;
    }
  }
  return fresh;
}

int fps_contains(const void *p, uint64_t key) {
  const Store *s = (const Store *)p;
  return s->keys[probe(s, key)] == key;
}

// Parent of key; 0 for roots and unknown keys (use fps_contains to
// distinguish).
uint64_t fps_get_parent(const void *p, uint64_t key) {
  const Store *s = (const Store *)p;
  uint64_t j = probe(s, key);
  return s->keys[j] == key ? s->parents[j] : 0;
}

// Walks parent pointers from fp to a root, writing the chain root-first
// into out (capacity cap). A dangling (unknown) parent terminates the
// chain but is included in it, matching the Python fallback. Returns the
// chain length, -1 if fp itself is unknown, or -2 if cap is too small
// (call again with a larger buffer).
int64_t fps_chain(const void *p, uint64_t fp, uint64_t *out, uint64_t cap) {
  const Store *s = (const Store *)p;
  if (s->keys[probe(s, fp)] != fp) return -1;
  uint64_t len = 0;
  uint64_t cur = fp;
  while (cur) {
    len++;
    uint64_t j = probe(s, cur);
    cur = s->keys[j] == cur ? s->parents[j] : 0;
  }
  if (len > cap) return -2;
  // Second pass: write root-first with the same transition rule.
  cur = fp;
  uint64_t i = len;
  while (cur) {
    out[--i] = cur;
    uint64_t j = probe(s, cur);
    cur = s->keys[j] == cur ? s->parents[j] : 0;
  }
  return (int64_t)len;
}

// Exports all (child, parent) pairs; returns the count written (<= cap).
uint64_t fps_export(const void *p, uint64_t *children, uint64_t *parents,
                    uint64_t cap) {
  const Store *s = (const Store *)p;
  uint64_t n = 0;
  for (uint64_t i = 0; i < s->capacity && n < cap; i++) {
    if (!s->keys[i]) continue;
    children[n] = s->keys[i];
    parents[n] = s->parents[i];
    n++;
  }
  return n;
}

}  // extern "C"
