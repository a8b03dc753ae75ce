// Open-addressing insert for the hash engine's visited set (sm_90a).
//
// Replaces no Pallas kernel: its JAX counterpart is the XLA
// `lax.while_loop` of gathers and a scatter-max in
// stateright_tpu/ops/hashset.py:197-287 (`_insert_jax`), which this
// computes. A table slot is one packed int64 key
// (stateright_tpu_torch/ops/fingerprint.py pack_keys: the u64 fingerprint
// with its top bit flipped); the empty slot is the packed (0, 0) pair,
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
// Three kernels, one thread a row, no scratch to clear and no memset:
// 1. probe: walk the sequence. A slot read non-empty is final (slots
//    never change once full), so a plain L2 read settles it; a slot read
//    empty is taken with a 64-bit atomicCAS(slot, EMPTY, key), whose
//    return value is the truth: EMPTY means this row inserted the key
//    (it stamps fresh[slot] = epoch), the key means another row did, any
//    other key means advance.
// 2. claim: each row whose slot was filled in this call (fresh == epoch)
//    does atomicMax(claim[slot], epoch << 32 | row + 1).
// 3. winner: is_new = fresh[slot] == epoch && claim[slot] == its tag.
// `epoch` counts the calls on one table, so claims of earlier calls are
// smaller than any of this call and fresh stamps of earlier calls never
// match: neither side array is cleared between calls (12 bytes a slot).
//
// Bound: device-memory bytes. Each key is read once (8 B), slot (8 B),
// is_new and overflow (1 B each) written once, and each probe reads one
// 8-byte slot at a random place (a 32-byte sector in practice), each
// insertion writes one. The design issues one dependent load a probe
// and an atomic only on an empty slot; at the engine's loads (< 70%,
// the occupancy warning) most rows settle at their first or second slot.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr u64 kEmpty = 0x8000000000000000ull;
constexpr int kThreads = 256;

__device__ __forceinline__ u64 slot_hash(u64 key, u64 mask) {
  // the JAX _slot_hash on the (lo, hi) limbs of the packed key
  const unsigned lo = static_cast<unsigned>(key);
  const unsigned hi = static_cast<unsigned>(key >> 32) ^ 0x80000000u;
  unsigned x = lo ^ (hi * 0x9E3779B9u);
  x ^= x >> 16;
  return static_cast<u64>(x) & mask;
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const u64* __restrict__ keys, const bool* __restrict__ active,
             i64 n, u64* table, int* fresh, u64 mask, int rounds, int epoch,
             i64* __restrict__ slot, bool* __restrict__ overflow) {
  const i64 i = static_cast<i64>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  i64 at = 0;  // inactive and overflowed rows report slot 0, as JAX
  bool over = false;
  if (active == nullptr || active[i]) {
    const u64 key = keys[i];
    u64 idx = slot_hash(key, mask);
    for (int probe = 0;;) {
      u64 cur = __ldcg(table + idx);
      if (cur == kEmpty) {
        cur = atomicCAS(table + idx, kEmpty, key);
        if (cur == kEmpty) fresh[idx] = epoch;  // this row inserted it
      }
      if (cur == kEmpty || cur == key) {
        at = static_cast<i64>(idx);
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
}

__global__ void __launch_bounds__(kThreads)
claim_kernel(const bool* __restrict__ active,
             const bool* __restrict__ overflow,
             const i64* __restrict__ slot, i64 n,
             const int* __restrict__ fresh, u64* claim, int epoch) {
  const i64 i = static_cast<i64>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n || (active != nullptr && !active[i]) || overflow[i]) return;
  const i64 s = slot[i];
  if (fresh[s] == epoch) {
    atomicMax(claim + s, (static_cast<u64>(epoch) << 32) |
                             static_cast<u64>(i + 1));
  }
}

__global__ void __launch_bounds__(kThreads)
winner_kernel(const bool* __restrict__ active,
              const bool* __restrict__ overflow,
              const i64* __restrict__ slot, i64 n,
              const int* __restrict__ fresh, const u64* __restrict__ claim,
              int epoch, bool* __restrict__ is_new) {
  const i64 i = static_cast<i64>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  bool won = false;
  if ((active == nullptr || active[i]) && !overflow[i]) {
    const i64 s = slot[i];
    won = fresh[s] == epoch &&
          claim[s] == ((static_cast<u64>(epoch) << 32) |
                       static_cast<u64>(i + 1));
  }
  is_new[i] = won;
}

}  // namespace

// keys[n] packed keys, active[n] (nullptr: every row), table / fresh /
// claim [mask + 1]; every row of slot[n], is_new[n] and overflow[n] is
// written (the wrapper allocates them uninitialised).
// Returns the first CUDA launch error, 0 when all three launched.
extern "C" int stpu_hash_insert(const void* keys, const void* active, i64 n,
                                void* table, void* fresh, void* claim,
                                i64 mask, int rounds, int epoch, void* slot,
                                void* is_new, void* overflow, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const bool* act = static_cast<const bool*>(active);
  probe_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const u64*>(keys), act, n, static_cast<u64*>(table),
      static_cast<int*>(fresh), static_cast<u64>(mask), rounds, epoch,
      static_cast<i64*>(slot), static_cast<bool*>(overflow));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  claim_kernel<<<grid, kThreads, 0, s>>>(
      act, static_cast<const bool*>(overflow),
      static_cast<const i64*>(slot), n, static_cast<const int*>(fresh),
      static_cast<u64*>(claim), epoch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  winner_kernel<<<grid, kThreads, 0, s>>>(
      act, static_cast<const bool*>(overflow),
      static_cast<const i64*>(slot), n, static_cast<const int*>(fresh),
      static_cast<const u64*>(claim), epoch, static_cast<bool*>(is_new));
  return static_cast<int>(cudaGetLastError());
}
