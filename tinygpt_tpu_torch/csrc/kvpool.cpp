// Native KV block-pool bookkeeping: refcounting allocator + content-
// addressed prefix index.
//
// This is the host-side memory manager behind the continuous-batching
// scheduler (tinygpt_tpu_torch/engine/scheduler.py): which pool block
// holds what, who references it, and which idle blocks hold reusable
// prompt prefixes (LRU-reclaimed under pressure). The same core as the
// JAX package's csrc/kvpool.cpp, built from the port's own sources
// (tinygpt_tpu_torch/ops/host_build.py).
//
// Semantics mirror tinygpt_tpu_torch/engine/paged_kv.py::BlockAllocator
// plus the scheduler's prefix maps; the Python implementation stays as the
// reference/fallback. Binding: ctypes
// (tinygpt_tpu_torch/engine/native_pool.py).

#include <cstddef>
#include <cstdint>
#include <map>
#include <unordered_map>
#include <vector>

namespace {

// 128-bit content-address key (SHA-256 chain digest truncated by the
// Python side); 64-bit non-crypto keys are collidable -> K/V aliasing.
struct Key128 {
  uint64_t hi, lo;
  bool operator==(const Key128& o) const { return hi == o.hi && lo == o.lo; }
};

struct Key128Hash {
  size_t operator()(const Key128& k) const {
    // digest bits are already uniform; fold.
    return static_cast<size_t>(k.hi ^ (k.lo * 0x9E3779B97F4A7C15ull));
  }
};

struct Pool {
  int32_t n_blocks;
  std::vector<int32_t> free_list;            // LIFO
  std::unordered_map<int32_t, int32_t> refcount;
  // idle-cached blocks in LRU order: tick -> block, block -> tick
  std::map<uint64_t, int32_t> idle_by_tick;
  std::unordered_map<int32_t, uint64_t> idle_tick;
  uint64_t tick = 0;
  // prefix index: chain hash -> block, block -> hash
  std::unordered_map<Key128, int32_t, Key128Hash> prefix;
  std::unordered_map<int32_t, Key128> block_hash;

  explicit Pool(int32_t n) : n_blocks(n) {
    free_list.reserve(n);
    for (int32_t b = n - 1; b >= 1; b--) free_list.push_back(b);  // 0 null
  }

  void evict_block(int32_t b) {
    auto it = block_hash.find(b);
    if (it != block_hash.end()) {
      prefix.erase(it->second);
      block_hash.erase(it);
    }
  }

  bool reclaim(int32_t n) {
    int32_t need = n - static_cast<int32_t>(free_list.size());
    if (need <= 0) return true;
    // feasibility first: a failed alloc must not destroy cached prefixes
    if (static_cast<int32_t>(idle_by_tick.size()) < need) return false;
    while (need-- > 0) {
      auto oldest = idle_by_tick.begin();
      int32_t b = oldest->second;
      idle_by_tick.erase(oldest);
      idle_tick.erase(b);
      evict_block(b);
      free_list.push_back(b);
    }
    return true;
  }
};

}  // namespace

extern "C" {

void* tg_pool_create(int32_t n_blocks) { return new Pool(n_blocks); }
void tg_pool_destroy(void* h) { delete static_cast<Pool*>(h); }

int32_t tg_pool_n_free(void* h) {
  auto* p = static_cast<Pool*>(h);
  return static_cast<int32_t>(p->free_list.size() + p->idle_by_tick.size());
}

// Allocate n blocks (rc=1 each) into out; returns 0 on success, -1 when
// even reclaiming every idle cached block cannot satisfy the request.
int32_t tg_pool_alloc(void* h, int32_t n, int32_t* out) {
  auto* p = static_cast<Pool*>(h);
  if (!p->reclaim(n)) return -1;
  for (int32_t i = 0; i < n; i++) {
    int32_t b = p->free_list.back();
    p->free_list.pop_back();
    p->refcount[b] = 1;
    out[i] = b;
  }
  return 0;
}

// Take an extra reference (reviving idle-cached blocks).
void tg_pool_share(void* h, const int32_t* blocks, int32_t n) {
  auto* p = static_cast<Pool*>(h);
  for (int32_t i = 0; i < n; i++) {
    int32_t b = blocks[i];
    if (b == 0) continue;
    auto it = p->idle_tick.find(b);
    if (it != p->idle_tick.end()) {
      p->idle_by_tick.erase(it->second);
      p->idle_tick.erase(it);
      p->refcount[b] = 1;
    } else {
      p->refcount[b] += 1;
    }
  }
}

// Drop one reference per block. keep[i] != 0 sends an rc==0 block to the
// idle-cached tier instead of the free list.
void tg_pool_release(void* h, const int32_t* blocks, const uint8_t* keep,
                     int32_t n) {
  auto* p = static_cast<Pool*>(h);
  for (int32_t i = 0; i < n; i++) {
    int32_t b = blocks[i];
    if (b == 0) continue;
    auto rc = p->refcount.find(b);
    int32_t r = (rc == p->refcount.end() ? 1 : rc->second) - 1;
    if (r > 0) {
      p->refcount[b] = r;
      continue;
    }
    p->refcount.erase(b);
    if (keep != nullptr && keep[i]) {
      uint64_t t = ++p->tick;
      p->idle_by_tick[t] = b;
      p->idle_tick[b] = t;
    } else {
      p->evict_block(b);
      p->free_list.push_back(b);
    }
  }
}

// Prefix index operations -----------------------------------------------

void tg_pool_register_prefix(void* h, uint64_t hash_hi, uint64_t hash_lo,
                             int32_t block) {
  auto* p = static_cast<Pool*>(h);
  Key128 k{hash_hi, hash_lo};
  if (p->prefix.count(k)) return;  // first writer wins
  p->prefix[k] = block;
  p->block_hash[block] = k;
}

// Returns the block for `hash`, or -1 when absent.
int32_t tg_pool_lookup_prefix(void* h, uint64_t hash_hi, uint64_t hash_lo) {
  auto* p = static_cast<Pool*>(h);
  auto it = p->prefix.find(Key128{hash_hi, hash_lo});
  return it == p->prefix.end() ? -1 : it->second;
}

int32_t tg_pool_block_is_registered(void* h, int32_t block) {
  return static_cast<Pool*>(h)->block_hash.count(block) ? 1 : 0;
}

int32_t tg_pool_n_idle_cached(void* h) {
  return static_cast<int32_t>(static_cast<Pool*>(h)->idle_by_tick.size());
}

int tg_pool_abi_version() { return 2; }

}  // extern "C"
