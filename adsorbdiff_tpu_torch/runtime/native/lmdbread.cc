// Native read path for single-file LMDB environments (format v1).
//
// Mirrors adsorbdiff_tpu_torch/data/lmdbio.py::LmdbReader (see its module
// docstring for the layout facts).  OC20 shards run to ~10^6 records and
// several GB: this reader mmaps the file, builds a flat record index once,
// and serves key/value bytes in bulk into caller-owned buffers (pickle decode
// stays in Python).  Bound via ctypes from
// adsorbdiff_tpu_torch/data/lmdb_native.py; built by
// adsorbdiff_tpu_torch/ops/host_build.py (g++ -O3 -shared, no dependencies).
// Every multi-byte field is read with memcpy (rd<T>), so no load depends on
// the file's alignment.
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xBEEFC0DE;
constexpr uint32_t kVersion = 1;
constexpr int kPageHdr = 16;
constexpr uint16_t kBranch = 0x01, kLeaf = 0x02, kMeta = 0x08;
constexpr uint16_t kBigData = 0x01;
constexpr uint64_t kInvalid = ~0ULL;

template <typename T> T rd(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

struct Rec {
  uint64_t node;  // absolute byte offset of the 8-byte node header
};

struct Env {
  int fd = -1;
  const uint8_t* mm = nullptr;
  uint64_t size = 0;
  uint64_t psize = 0;
  uint64_t root = kInvalid;
  uint64_t entries = 0;
  std::vector<Rec> index;  // key order
};

bool is_meta(const uint8_t* mm, uint64_t size, uint64_t base) {
  if (base + kPageHdr + 16 > size) return false;
  uint16_t flags = rd<uint16_t>(mm + base + 10);
  uint32_t magic = rd<uint32_t>(mm + base + kPageHdr);
  uint32_t version = rd<uint32_t>(mm + base + kPageHdr + 4);
  return (flags & kMeta) && magic == kMagic && version == kVersion;
}

uint64_t detect_psize(const uint8_t* mm, uint64_t size) {
  // preferred: free-DB md_pad slot of meta page 0 (mm_psize in mdb.c)
  if (is_meta(mm, size, 0)) {
    uint32_t pad = rd<uint32_t>(mm + kPageHdr + 24);
    if (pad >= 512 && pad <= 65536 && (pad & (pad - 1)) == 0 && size >= 2 * (uint64_t)pad)
      return pad;
  }
  const uint64_t cands[] = {4096, 8192, 16384, 32768, 65536, 512, 1024, 2048};
  for (uint64_t ps : cands) {
    if (size < 2 * ps) continue;
    if (is_meta(mm, size, 0) && is_meta(mm, size, ps)) return ps;
  }
  return 0;
}

// Walk the tree depth-first in key order, appending leaf node offsets.
bool build_index(Env* e) {
  if (e->root == kInvalid) return true;
  std::vector<uint64_t> stack{e->root};
  e->index.reserve(e->entries);
  while (!stack.empty()) {
    uint64_t pgno = stack.back();
    stack.pop_back();
    uint64_t base = pgno * e->psize;
    if (base + e->psize > e->size) return false;
    uint16_t flags = rd<uint16_t>(e->mm + base + 10);
    uint16_t lower = rd<uint16_t>(e->mm + base + 12);
    int n = (lower - kPageHdr) / 2;
    if (n < 0) return false;
    if (flags & kBranch) {
      // push children reversed to preserve key order on the stack
      for (int i = n - 1; i >= 0; --i) {
        uint16_t off = rd<uint16_t>(e->mm + base + kPageHdr + 2 * i);
        const uint8_t* node = e->mm + base + off;
        uint64_t child = (uint64_t)rd<uint16_t>(node) |
                         ((uint64_t)rd<uint16_t>(node + 2) << 16) |
                         ((uint64_t)rd<uint16_t>(node + 4) << 32);
        stack.push_back(child);
      }
    } else if (flags & kLeaf) {
      for (int i = 0; i < n; ++i) {
        uint16_t off = rd<uint16_t>(e->mm + base + kPageHdr + 2 * i);
        e->index.push_back({base + off});
      }
    } else {
      return false;
    }
  }
  return true;
}

struct NodeView {
  const uint8_t* key;
  uint64_t ksize;
  const uint8_t* val;
  uint64_t vsize;
};

bool node_view(const Env* e, uint64_t node_off, NodeView* out) {
  const uint8_t* node = e->mm + node_off;
  uint64_t dsize = (uint64_t)rd<uint16_t>(node) | ((uint64_t)rd<uint16_t>(node + 2) << 16);
  uint16_t nflags = rd<uint16_t>(node + 4);
  uint16_t ksize = rd<uint16_t>(node + 6);
  out->key = node + 8;
  out->ksize = ksize;
  out->vsize = dsize;
  if (nflags & kBigData) {
    uint64_t ovf = rd<uint64_t>(node + 8 + ksize);
    uint64_t obase = ovf * e->psize;
    if (obase + kPageHdr + dsize > e->size) return false;
    out->val = e->mm + obase + kPageHdr;
  } else {
    out->val = node + 8 + ksize;
    if (node_off + 8 + ksize + dsize > e->size) return false;
  }
  return true;
}

}  // namespace

extern "C" {

void* lmr_open(const char* path) {
  Env* e = new Env();
  e->fd = ::open(path, O_RDONLY);
  if (e->fd < 0) {
    delete e;
    return nullptr;
  }
  struct stat st;
  if (fstat(e->fd, &st) != 0 || st.st_size < 2 * 512) {
    ::close(e->fd);
    delete e;
    return nullptr;
  }
  e->size = (uint64_t)st.st_size;
  void* mm = mmap(nullptr, e->size, PROT_READ, MAP_PRIVATE, e->fd, 0);
  if (mm == MAP_FAILED) {
    ::close(e->fd);
    delete e;
    return nullptr;
  }
  e->mm = (const uint8_t*)mm;
  e->psize = detect_psize(e->mm, e->size);
  if (!e->psize) goto fail;
  {
    // live meta = larger txnid of pages 0/1
    uint64_t best_txn = 0;
    bool found = false;
    for (int pg = 0; pg < 2; ++pg) {
      uint64_t base = (uint64_t)pg * e->psize;
      if (!is_meta(e->mm, e->size, base)) continue;
      const uint8_t* main_db = e->mm + base + kPageHdr + 24 + 48;  // free DB then main DB
      uint64_t entries = rd<uint64_t>(main_db + 32);
      uint64_t root = rd<uint64_t>(main_db + 40);
      uint64_t txnid = rd<uint64_t>(e->mm + base + kPageHdr + 24 + 96 + 8);
      if (!found || txnid >= best_txn) {
        best_txn = txnid;
        e->entries = entries;
        e->root = root;
        found = true;
      }
    }
    if (!found) goto fail;
  }
  if (!build_index(e)) goto fail;
  return e;
fail:
  munmap((void*)e->mm, e->size);
  ::close(e->fd);
  delete e;
  return nullptr;
}

void lmr_close(void* h) {
  Env* e = (Env*)h;
  if (!e) return;
  munmap((void*)e->mm, e->size);
  ::close(e->fd);
  delete e;
}

long long lmr_count(void* h) { return (long long)((Env*)h)->index.size(); }
long long lmr_psize(void* h) { return (long long)((Env*)h)->psize; }

// Per-record key/value sizes for records [start, start+count).
int lmr_sizes(void* h, long long start, long long count, long long* ks, long long* vs) {
  Env* e = (Env*)h;
  if (start < 0 || start + count > (long long)e->index.size()) return -1;
  for (long long i = 0; i < count; ++i) {
    NodeView nv;
    if (!node_view(e, e->index[start + i].node, &nv)) return -2;
    ks[i] = (long long)nv.ksize;
    vs[i] = (long long)nv.vsize;
  }
  return 0;
}

// Concatenated key and value bytes for records [start, start+count), in the
// order lmr_sizes reported.  Caller allocates kbuf/vbuf from those sizes.
int lmr_read(void* h, long long start, long long count, uint8_t* kbuf, uint8_t* vbuf) {
  Env* e = (Env*)h;
  if (start < 0 || start + count > (long long)e->index.size()) return -1;
  for (long long i = 0; i < count; ++i) {
    NodeView nv;
    if (!node_view(e, e->index[start + i].node, &nv)) return -2;
    std::memcpy(kbuf, nv.key, nv.ksize);
    kbuf += nv.ksize;
    std::memcpy(vbuf, nv.val, nv.vsize);
    vbuf += nv.vsize;
  }
  return 0;
}

// Keys only — lets callers scan/sort 10^6 keys without touching value bytes.
int lmr_read_keys(void* h, long long start, long long count, uint8_t* kbuf) {
  Env* e = (Env*)h;
  if (start < 0 || start + count > (long long)e->index.size()) return -1;
  for (long long i = 0; i < count; ++i) {
    NodeView nv;
    if (!node_view(e, e->index[start + i].node, &nv)) return -2;
    std::memcpy(kbuf, nv.key, nv.ksize);
    kbuf += nv.ksize;
  }
  return 0;
}

// Point lookup (linear over the index is fine for debug; binary search since
// the index is in memcmp key order).
long long lmr_get(void* h, const uint8_t* key, long long ksize, uint8_t* out, long long cap) {
  Env* e = (Env*)h;
  long long lo = 0, hi = (long long)e->index.size() - 1;
  while (lo <= hi) {
    long long mid = (lo + hi) / 2;
    NodeView nv;
    if (!node_view(e, e->index[mid].node, &nv)) return -2;
    uint64_t m = nv.ksize < (uint64_t)ksize ? nv.ksize : (uint64_t)ksize;
    int c = std::memcmp(nv.key, key, m);
    if (c == 0) c = (nv.ksize > (uint64_t)ksize) - (nv.ksize < (uint64_t)ksize);
    if (c == 0) {
      if ((long long)nv.vsize > cap) return -3;
      std::memcpy(out, nv.val, nv.vsize);
      return (long long)nv.vsize;
    }
    if (c < 0)
      lo = mid + 1;
    else
      hi = mid - 1;
  }
  return -1;
}

}  // extern "C"
