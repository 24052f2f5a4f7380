// Native k-mer count aggregator: open-addressing hash map on int64 keys.
//
// The host-side merge sink for device-produced (key, count) batches
// (ops/kmer.py: unique_counts_batch) on the engine's host-store path. A
// Python dict costs ~100ns+/op and GC pressure at WGS scale (billions of
// k-mers); this store is a flat linear-probing table with power-of-two
// sizing and automatic growth.
//
// A key is the k-mer's 2-bit string (A=0 C=1 G=2 T=3, first base most
// significant), so every key of a k <= 31 k-mer is below 2^62.
//
// C ABI for ctypes.

#include <cstdint>
#include <vector>

namespace {

struct Slot {
  uint64_t key;
  uint64_t count;  // count==0 marks an empty slot (keys are stored
                   // verbatim; key 0 is protected by the count flag)
};

struct Store {
  std::vector<Slot> slots;
  uint64_t size = 0;  // occupied slots
  uint64_t mask = 0;

  explicit Store(uint64_t cap_pow2) {
    uint64_t cap = 1;
    while (cap < cap_pow2) cap <<= 1;
    slots.assign(cap, Slot{0, 0});
    mask = cap - 1;
  }

  static uint64_t hash(uint64_t k) {
    // splitmix64 finalizer
    k ^= k >> 30;
    k *= 0xbf58476d1ce4e5b9ULL;
    k ^= k >> 27;
    k *= 0x94d049bb133111ebULL;
    k ^= k >> 31;
    return k;
  }

  void grow() {
    std::vector<Slot> old;
    old.swap(slots);
    slots.assign(old.size() * 2, Slot{0, 0});
    mask = slots.size() - 1;
    size = 0;
    for (const Slot& s : old) {
      if (s.count != 0) add(s.key, s.count);
    }
  }

  void add(uint64_t key, uint64_t count) {
    if ((size + 1) * 4 > slots.size() * 3) grow();  // load factor 0.75
    uint64_t i = hash(key) & mask;
    while (true) {
      Slot& s = slots[i];
      if (s.count == 0) {
        s.key = key;
        s.count = count;
        ++size;
        return;
      }
      if (s.key == key) {
        s.count += count;
        return;
      }
      i = (i + 1) & mask;
    }
  }

  uint64_t get(uint64_t key) const {
    uint64_t i = hash(key) & mask;
    while (true) {
      const Slot& s = slots[i];
      if (s.count == 0) return 0;
      if (s.key == key) return s.count;
      i = (i + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

void* ks_new(uint64_t initial_capacity) {
  return new Store(initial_capacity < 16 ? 16 : initial_capacity);
}

void ks_free(void* h) { delete static_cast<Store*>(h); }

// Merge a device batch: counts[i] <= 0 entries are skipped (padding).
void ks_merge(void* h, const int64_t* keys, const int64_t* counts,
              int64_t n) {
  auto* s = static_cast<Store*>(h);
  for (int64_t i = 0; i < n; ++i) {
    if (counts[i] > 0) {
      s->add(static_cast<uint64_t>(keys[i]),
             static_cast<uint64_t>(counts[i]));
    }
  }
}

uint64_t ks_size(void* h) { return static_cast<Store*>(h)->size; }

uint64_t ks_total(void* h) {
  auto* s = static_cast<Store*>(h);
  uint64_t t = 0;
  for (const Slot& sl : s->slots) t += sl.count;
  return t;
}

uint64_t ks_get(void* h, int64_t key) {
  return static_cast<Store*>(h)->get(static_cast<uint64_t>(key));
}

// Dump up to cap entries in table order; returns the number written.
uint64_t ks_dump(void* h, int64_t* out_keys, int64_t* out_counts,
                 uint64_t cap) {
  auto* s = static_cast<Store*>(h);
  uint64_t w = 0;
  for (const Slot& sl : s->slots) {
    if (sl.count != 0) {
      if (w >= cap) break;
      out_keys[w] = static_cast<int64_t>(sl.key);
      out_counts[w] = static_cast<int64_t>(sl.count);
      ++w;
    }
  }
  return w;
}

// One-pass decoder of the drain codec's byte planes (ops/kmer.py:
// plane_pack; its plain version is decode_planes_numpy there). planes is
// kp + cp rows of m bytes: entry i's key delta is the little-endian
// kp-byte integer planes[p * m + i], added mod 2^64 to the key before it
// (entry 0's delta is 0 and key0 the first key, so deltas of keys in any
// order wrap back exactly); its count is the cp-byte integer of the
// trailing planes, or 1 when cp == 0.
void ks_decode_planes(const uint8_t* planes, int64_t m, int32_t kp,
                      int32_t cp, uint64_t key0, int64_t* out_keys,
                      int64_t* out_counts) {
  uint64_t key = key0;
  for (int64_t i = 0; i < m; ++i) {
    uint64_t delta = 0;
    for (int32_t p = 0; p < kp; ++p)
      delta |= static_cast<uint64_t>(planes[p * m + i]) << (8 * p);
    key += delta;
    out_keys[i] = static_cast<int64_t>(key);
    uint64_t count = 1;
    if (cp > 0) {
      count = 0;
      for (int32_t p = 0; p < cp; ++p)
        count |= static_cast<uint64_t>(planes[(kp + p) * m + i]) << (8 * p);
    }
    out_counts[i] = static_cast<int64_t>(count);
  }
}

}  // extern "C"
