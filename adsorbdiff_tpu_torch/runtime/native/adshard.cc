// adshard: native columnar shard reader + padded-batch collator.
//
// The host-side hot path of training is batch assembly: gathering S ragged
// systems and writing them into padded [B, N, ...] buffers every step.  This
// file mmaps the raw .adbin shard format (written by
// adsorbdiff_tpu_torch/data/native.py::write_shard_bin, byte for byte the JAX
// package's) and fills caller-provided padded buffers with a thread pool,
// exposed to Python via ctypes.  Built by adsorbdiff_tpu_torch/ops/host_build.py.
//
// .adbin layout (little-endian, no padding):
//   magic "ADSB" | uint32 version | uint64 n_systems | uint64 total_atoms
//   offsets  int64 [n_systems + 1]
//   natoms   int32 [n_systems]
//   cell     f32   [n_systems, 3, 3]
//   sid      int64 [n_systems]
//   fid      int64 [n_systems]
//   energy   f32   [n_systems]
//   y_relaxed f32  [n_systems]
//   has_forces uint8
//   pos          f32 [total_atoms, 3]
//   atomic_numbers int32 [total_atoms]
//   tags         int32 [total_atoms]
//   fixed        uint8 [total_atoms]
//   pos_relaxed  f32 [total_atoms, 3]
//   forces       f32 [total_atoms, 3]          (iff has_forces)
//
// Every array after the one-byte has_forces starts at an odd offset, so the
// columns are kept as byte pointers and every read is a memcpy: no load
// assumes an alignment the file does not give.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>

namespace {

template <typename T> T rd(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  return v;
}

struct Shard {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t n_systems = 0;
  uint64_t total_atoms = 0;
  // column starts, as byte pointers into the mapping
  const uint8_t* offsets = nullptr;         // int64 [n + 1]
  const uint8_t* natoms = nullptr;          // int32 [n]
  const uint8_t* cell = nullptr;            // f32 [n, 9]
  const uint8_t* sid = nullptr;             // int64 [n]
  const uint8_t* fid = nullptr;             // int64 [n]
  const uint8_t* energy = nullptr;          // f32 [n]
  const uint8_t* y_relaxed = nullptr;       // f32 [n]
  bool has_forces = false;
  const uint8_t* pos = nullptr;             // f32 [atoms, 3]
  const uint8_t* atomic_numbers = nullptr;  // int32 [atoms]
  const uint8_t* tags = nullptr;            // int32 [atoms]
  const uint8_t* fixed = nullptr;           // uint8 [atoms]
  const uint8_t* pos_relaxed = nullptr;     // f32 [atoms, 3]
  const uint8_t* forces = nullptr;          // f32 [atoms, 3]

  int64_t offset(int64_t i) const { return rd<int64_t>(offsets + 8 * i); }
  int32_t count(int64_t i) const { return rd<int32_t>(natoms + 4 * i); }
};

// Batches that copy less than this many bytes of padded atom rows are filled
// on the calling thread: starting threads costs more than such a copy (a
// B=48 batch of 80-atom systems is ~0.18 MB).
constexpr int64_t kMinThreadedBytes = 1 << 20;
// bytes a padded atom row takes over all atom columns (pos, z, tags, fixed,
// pos_relaxed, forces)
constexpr int64_t kAtomBytes = 12 + 4 + 4 + 1 + 12 + 12;

void unmap(Shard* s) {
  munmap(const_cast<uint8_t*>(s->base), s->size);
  ::close(s->fd);
  delete s;
}

}  // namespace

extern "C" {

void* adb_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 24) { ::close(fd); return nullptr; }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) { ::close(fd); return nullptr; }

  auto* s = new Shard();
  s->fd = fd;
  s->base = static_cast<const uint8_t*>(mem);
  s->size = st.st_size;

  const uint8_t* p = s->base;
  if (std::memcmp(p, "ADSB", 4) != 0 || rd<uint32_t>(p + 4) != 1) { unmap(s); return nullptr; }
  s->n_systems = rd<uint64_t>(p + 8);
  s->total_atoms = rd<uint64_t>(p + 16);
  p += 24;
  const uint64_t n = s->n_systems, atoms = s->total_atoms;
  // the file must hold every column: checked before any pointer past the end is formed
  const uint64_t need = 24 + 8 * (n + 1) + 4 * n + 36 * n + 8 * n + 8 * n + 4 * n + 4 * n + 1 +
                        12 * atoms + 4 * atoms + 4 * atoms + atoms + 12 * atoms;
  if (n > s->size || atoms > s->size || need > s->size) { unmap(s); return nullptr; }
  s->offsets = p; p += 8 * (n + 1);
  s->natoms = p; p += 4 * n;
  s->cell = p; p += 36 * n;
  s->sid = p; p += 8 * n;
  s->fid = p; p += 8 * n;
  s->energy = p; p += 4 * n;
  s->y_relaxed = p; p += 4 * n;
  s->has_forces = (*p != 0); p += 1;
  s->pos = p; p += 12 * atoms;
  s->atomic_numbers = p; p += 4 * atoms;
  s->tags = p; p += 4 * atoms;
  s->fixed = p; p += atoms;
  s->pos_relaxed = p; p += 12 * atoms;
  if (s->has_forces) {
    if (need + 12 * atoms > s->size) { unmap(s); return nullptr; }
    s->forces = p;
  }
  return s;
}

void adb_close(void* handle) {
  auto* s = static_cast<Shard*>(handle);
  if (s) unmap(s);
}

int64_t adb_num_systems(void* handle) {
  return static_cast<Shard*>(handle)->n_systems;
}

void adb_natoms(void* handle, int32_t* out) {
  auto* s = static_cast<Shard*>(handle);
  std::memcpy(out, s->natoms, 4 * s->n_systems);
}

// Fill padded [B, max_atoms, ...] buffers for the given system indices, with
// up to n_threads threads.  All out_* buffers must be zero-initialized by the
// caller; atom_mask and fixed are written as bytes 0/1 (a torch bool
// tensor's storage).  Returns 0 on success, -1 on an index out of range or a
// system over max_atoms.
int adb_fill_batch(
    void* handle, const int64_t* indices, int64_t b, int64_t max_atoms,
    float* out_pos, int32_t* out_z, int32_t* out_tags, uint8_t* out_fixed,
    float* out_cell, int32_t* out_natoms, uint8_t* out_mask,
    int32_t* out_sid, int32_t* out_fid, float* out_energy, float* out_y_relaxed,
    float* out_pos_relaxed, float* out_forces, int n_threads) {
  auto* s = static_cast<Shard*>(handle);
  for (int64_t i = 0; i < b; ++i) {
    int64_t gi = indices[i];
    if (gi < 0 || gi >= static_cast<int64_t>(s->n_systems)) return -1;
    if (s->count(gi) > max_atoms) return -1;
  }

  auto fill_one = [&](int64_t i) {
    const int64_t gi = indices[i];
    const int64_t a = s->offset(gi);
    const int32_t n = s->count(gi);
    std::memcpy(out_pos + i * max_atoms * 3, s->pos + 12 * a, 12 * n);
    std::memcpy(out_z + i * max_atoms, s->atomic_numbers + 4 * a, 4 * n);
    std::memcpy(out_tags + i * max_atoms, s->tags + 4 * a, 4 * n);
    // any non-zero byte is true, as numpy's astype(bool) reads it
    for (int32_t j = 0; j < n; ++j) out_fixed[i * max_atoms + j] = s->fixed[a + j] != 0;
    std::memcpy(out_cell + i * 9, s->cell + 36 * gi, 36);
    out_natoms[i] = n;
    std::memset(out_mask + i * max_atoms, 1, n);
    out_sid[i] = static_cast<int32_t>(rd<int64_t>(s->sid + 8 * gi));
    out_fid[i] = static_cast<int32_t>(rd<int64_t>(s->fid + 8 * gi));
    out_energy[i] = rd<float>(s->energy + 4 * gi);
    out_y_relaxed[i] = rd<float>(s->y_relaxed + 4 * gi);
    std::memcpy(out_pos_relaxed + i * max_atoms * 3, s->pos_relaxed + 12 * a, 12 * n);
    if (out_forces && s->has_forces) {
      std::memcpy(out_forces + i * max_atoms * 3, s->forces + 12 * a, 12 * n);
    }
  };

  if (n_threads <= 1 || b < 4 || b * max_atoms * kAtomBytes < kMinThreadedBytes) {
    for (int64_t i = 0; i < b; ++i) fill_one(i);
  } else {
    std::vector<std::thread> pool;
    const int nt = static_cast<int>(std::min<int64_t>(n_threads, b));
    for (int t = 0; t < nt; ++t) {
      pool.emplace_back([&, t]() {
        for (int64_t i = t; i < b; i += nt) fill_one(i);
      });
    }
    for (auto& th : pool) th.join();
  }
  return 0;
}

int adb_has_forces(void* handle) {
  return static_cast<Shard*>(handle)->has_forces ? 1 : 0;
}

}  // extern "C"
