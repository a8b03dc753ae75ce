// Open-addressing insert for the hash engine's visited set (sm_90a).
//
// Replaces no Pallas kernel: its JAX counterpart is the XLA
// `lax.while_loop` of gathers and a scatter-max in
// stateright_tpu/ops/hashset.py:197-287 (`_insert_jax`), which this
// computes. A key is one packed int64 (stateright_tpu_torch/ops/
// fingerprint.py pack_keys: the u64 fingerprint with its top bit
// flipped); the empty slot holds the packed (0, 0) pair,
// 0x8000000000000000, and no fingerprint is 0.
//
// What it must keep of the JAX loop:
// (a) of the rows holding one key that was absent before the call,
//     exactly one reports is_new, and it is the HIGHEST row (JAX claims
//     a slot by a scatter-max of row + 1). The engine's next frontier,
//     parents and eventually-bits follow that row.
// (b) slots only go from empty to full, so the rows of one key can never
//     insert it twice. Which slot a key lands in may differ from JAX's:
//     it depends on the order in which different keys claim slots.
// (c) each key walks JAX's probe sequence: the slot hash, then
//     probe += 1, idx = (idx + probe) & mask; a key overflows when its
//     probe depth reaches `rounds` (after `rounds` slots of other keys).
//
// A slot is one 16-byte entry {key, tag} (the wrapper's int64
// [capacity, 2] array, 16-byte aligned), so a key and its tag always
// share one 32-byte sector. tag = epoch << 32 | (row + 1) of the highest
// row that claimed the slot in the call `epoch` that filled it; 0 means
// never tagged. `epoch` counts the calls on one table (from 1), so a
// slot filled in an earlier call holds a non-zero tag of an earlier
// epoch, and nothing is cleared between calls.
//
// Two kernels, one thread a row:
// 1. probe_claim: walk the sequence, reading each entry with one 16-byte
//    L2 load. A key read non-empty is final (slots never change once
//    full). An empty key is taken with a 64-bit atomicCAS of the key
//    word, whose return value is the truth: EMPTY means this row
//    inserted the key, the key means another row did, any other key
//    means advance. On its own key the row knows from the same sector
//    whether the slot was filled in this call: tag == 0 or tag >> 32 ==
//    epoch (and, after a CAS, always). Such a row, unless the tag it
//    read already beats its own, does atomicMax(tag, epoch << 32 | row +
//    1) on the sector it just touched and writes is_new = 1, a
//    candidate; every other row is finished, is_new = 0. A row of a key
//    present before the call costs one sector, the bound's own read.
// 2. winner: only candidates read their slot's tag again (one random
//    8-byte read a row of a new key): is_new = tag == its own. It needs
//    every atomic of pass 1 done, hence a second launch.
//
// Where it can go wrong:
// - Empty slots must have tag 0. An empty slot with a stale tag of an
//   earlier epoch would make a row that reads the slot between its
//   inserter's CAS and the inserter's atomicMax take the slot for an old
//   one: that row would never claim, and when it is the highest row the
//   winner is wrong, nondeterministically. DeviceHashSet.from_keys and
//   .reset write every entry whole (epoch-0 tag 1 on a full slot, 0 on
//   an empty one); anything that writes a table (tiering, checkpoints)
//   must keep this rule.
// - Alignment: the 16-byte load needs a 16-byte aligned entry array; the
//   wrapper checks it and raises.
// - The tag packs row + 1 in 32 bits and epoch in 31: the wrapper
//   refuses n >= 2^32 - 1 rows and counts epochs below 2^31 - 1.
// - The two words of one 16-byte load need not be read at one moment;
//   the test above holds all the same, since a slot filled in this call
//   only ever holds tag 0 or a tag of this epoch.
//
// Bound: device-memory bytes. Each key is read once (8 B), slot (8 B),
// is_new and overflow (1 B each) written once, and each probe reads one
// 8-byte slot at a random place (a 32-byte sector in practice), each
// insertion writes one. The design touches one random sector a probe,
// the CAS and the atomicMax on the sector the probe read, and one more
// random read only for rows of new keys; pass 2 streams is_new (1 B a
// row) for the rest.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr u64 kEmpty = 0x8000000000000000ull;
constexpr int kThreads = 256;

struct __align__(16) Entry {
  u64 key;
  u64 tag;
};

__device__ __forceinline__ u64 slot_hash(u64 key, u64 mask) {
  // the JAX _slot_hash on the (lo, hi) limbs of the packed key
  const unsigned lo = static_cast<unsigned>(key);
  const unsigned hi = static_cast<unsigned>(key >> 32) ^ 0x80000000u;
  unsigned x = lo ^ (hi * 0x9E3779B9u);
  x ^= x >> 16;
  return static_cast<u64>(x) & mask;
}

__global__ void __launch_bounds__(kThreads)
probe_claim_kernel(const u64* __restrict__ keys,
                   const bool* __restrict__ active, i64 n, Entry* entries,
                   u64 mask, int rounds, int epoch, i64* __restrict__ slot,
                   bool* __restrict__ is_new, bool* __restrict__ overflow,
                   const i64* __restrict__ n_dev,
                   const i64* __restrict__ epoch_dev) {
  // with device counts, the key count and the epoch are read from memory
  if (n_dev != nullptr) n = *n_dev;
  if (epoch_dev != nullptr) epoch = static_cast<int>(*epoch_dev);
  const i64 i = static_cast<i64>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  i64 at = 0;  // inactive and overflowed rows report slot 0, as JAX
  bool over = false;
  bool candidate = false;
  if (active == nullptr || active[i]) {
    const u64 key = keys[i];
    const u64 mine = (static_cast<u64>(epoch) << 32) | static_cast<u64>(i + 1);
    u64 idx = slot_hash(key, mask);
    for (int probe = 0;;) {
      const longlong2 e =
          __ldcg(reinterpret_cast<const longlong2*>(entries + idx));
      u64 cur = static_cast<u64>(e.x);
      u64 tag = static_cast<u64>(e.y);
      if (cur == kEmpty) {
        cur = atomicCAS(&entries[idx].key, kEmpty, key);
        if (cur == kEmpty) cur = key;  // this row inserted it
        tag = 0;  // empty at this call's read: filled in this call
      }
      if (cur == key) {
        at = static_cast<i64>(idx);
        // filled in this call, and not yet claimed by a higher row
        candidate = (tag == 0 || (tag >> 32) == static_cast<u64>(epoch)) &&
                    tag < mine;
        if (candidate) atomicMax(&entries[idx].tag, mine);
        break;
      }
      if (++probe >= rounds) {
        over = true;
        break;
      }
      idx = (idx + static_cast<u64>(probe)) & mask;
    }
  }
  slot[i] = at;
  overflow[i] = over;
  is_new[i] = candidate;  // settled by winner_kernel
}

__global__ void __launch_bounds__(kThreads)
winner_kernel(i64 n, const Entry* __restrict__ entries, int epoch,
              const i64* __restrict__ slot, bool* is_new,
              const i64* __restrict__ n_dev,
              const i64* __restrict__ epoch_dev) {
  if (n_dev != nullptr) n = *n_dev;
  if (epoch_dev != nullptr) epoch = static_cast<int>(*epoch_dev);
  const i64 i = static_cast<i64>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n || !is_new[i]) return;
  is_new[i] = entries[slot[i]].tag ==
              ((static_cast<u64>(epoch) << 32) | static_cast<u64>(i + 1));
}

}  // namespace

// keys[n] packed keys, active[n] (nullptr: every row), entries[mask + 1]
// {key, tag} (16-byte aligned); every row of slot[n], is_new[n] and
// overflow[n] is written (the wrapper allocates them uninitialised).
// Where n_dev is not null, the key count is the one int64 it points at
// in device memory, read by the kernels (n is then the keys' capacity,
// which the grid covers; rows past the count exit and only rows
// [0, *n_dev) of the outputs are written), and so is the call's epoch
// where epoch_dev is not null (the caller advances it on the device):
// no host read, so the launch stays valid in a CUDA graph replayed with
// other counts. Returns the first CUDA launch error, 0 when both
// launched.
extern "C" int stpu_hash_insert(const void* keys, const void* active, i64 n,
                                void* entries, i64 mask, int rounds,
                                int epoch, void* slot, void* is_new,
                                void* overflow, const void* n_dev,
                                const void* epoch_dev, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const i64* n_p = static_cast<const i64*>(n_dev);
  const i64* e_p = static_cast<const i64*>(epoch_dev);
  probe_claim_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const u64*>(keys), static_cast<const bool*>(active), n,
      static_cast<Entry*>(entries), static_cast<u64>(mask), rounds, epoch,
      static_cast<i64*>(slot), static_cast<bool*>(is_new),
      static_cast<bool*>(overflow), n_p, e_p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  winner_kernel<<<grid, kThreads, 0, s>>>(
      n, static_cast<const Entry*>(entries), epoch,
      static_cast<const i64*>(slot), static_cast<bool*>(is_new), n_p, e_p);
  return static_cast<int>(cudaGetLastError());
}
