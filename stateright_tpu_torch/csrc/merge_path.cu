// Merge Path kernels for the sorted visited set (sm_90a).
//
// Keys are packed int64 sort keys (stateright_tpu_torch/ops/fingerprint.py
// pack_keys): the u64 fingerprint with its top bit flipped, so a signed
// compare orders like the unsigned (hi, lo) pair and the all-ones
// sentinel is INT64_MAX. Both inputs of every kernel are sorted
// ascending; ties order A first.
//
// One templated body, merge_path_tiles<THREADS, R, MEMBER>, serves both
// ops, each as its own kernel:
//
// * merge_tile_kernel (MEMBER = false) replaces the Pallas `_merge_kernel`
//   (stateright_tpu/ops/merge.py:232, pallas_call at :343): the stable
//   merge of A and B, A first on ties, into out[Na + Nb];
// * member_tile_kernel (MEMBER = true) replaces the Pallas `_member_kernel`
//   (stateright_tpu/ops/merge.py:282, pallas_call at :373): for each
//   query q of Q, whether q occurs in A. Walking the merge of A and Q
//   (A first on ties), q is in A iff the last A key merged before q -
//   the largest A key <= q - equals q. Each query's flag is written by
//   the thread that merges it, so the kernel writes every row of out[Nq].
//
// Bound: both are bound by device-memory bytes. Merge reads each key
// once and writes it once (16 bytes a merged row); member reads A and Q
// once and writes one byte a query. The design keeps the card's memory
// busy and everything else on chip:
//
// 1. One launch per call, a persistent grid. The merged sequence is cut
//    into tiles of T = THREADS * R rows and each CTA owns one contiguous
//    run of `tiles_per_cta` tiles (the grid is at most the CTAs the card
//    holds at once, and never more CTAs than tiles of the buffers; with
//    counts read from device memory the runs are sized on the device). Warps 0 and 1 find
//    the run's two Merge Path diagonals in device memory with a
//    warp-cooperative search (32 probes and one ballot a step, about 6
//    steps over 10M keys), so the CTA merges A[a0, a1) with B[b0, b1) on
//    its own: no partition launch and no scratch.
// 2. Two shared-memory rings, one for A, one for B (or Q), of D = 2
//    tiles and two keys each, hold each stream's next keys: the current
//    tile's window (at most T keys a side) and one tile of read-ahead. Thread 0 fills them with TMA bulk copies
//    (cp.async.bulk, completion counted in bytes on an mbarrier per
//    fill generation). Ring slot of key i is (i + phase) mod S, where
//    phase is bit 3 of the stream's base address, so 16-byte-aligned
//    keys in device memory land on 16-byte-aligned slots; each copy is
//    widened by at most one key a side to 16-byte boundaries (the two
//    spare slots keep that from touching a live key), and a key past
//    an end of A or B goes alone by an 8-byte cp.async. Nothing is read
//    past the CTA's run but those widened keys. After each tile thread
//    0 refills exactly the slots the tile consumed; tile k waits only
//    for the generation issued two tiles earlier. (Deeper rings cost
//    CTAs an SM and were slower.)
// 3. Per thread, one diagonal search in the rings (log2 T probes), then
//    a serial merge of its R rows in registers: one compare a row. R is
//    odd so that the staging writes of a warp (stride R keys) hit every
//    bank pair once.
// 4. Stores go through shared memory: merged keys as 16-byte stores
//    (8 bytes at an unaligned edge), member flags as 4-byte words (bytes
//    only at a ragged edge). Each tile writes exactly its own output
//    rows, so CTAs need no order.
//
// Member's halo: a query whose thread starts with no A key in the
// window still needs A[a_s - 1], the last A key before the window. The
// CTA reads it from device memory once (absent when a_s == 0) and then
// carries it from tile to tile in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 8-byte cp.async (a ragged key at an end of A or B), tracked by groups
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers and TMA bulk copies (global -> shared, completion counted
// in bytes on an mbarrier)
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ i64 imin(i64 x, i64 y) { return x < y ? x : y; }
__device__ __forceinline__ i64 imax(i64 x, i64 y) { return x > y ? x : y; }

// The Merge Path split of diagonal d (the number of A rows among the
// first d merged rows, A first on ties), found by one warp: each step
// probes 32 points of [lo, hi) at once and keeps the gap where the
// predicate "b[d - i - 1] < a[i]" (monotone in i) turns true.
__device__ i64 warp_split(const i64* __restrict__ a, i64 na,
                          const i64* __restrict__ b, i64 nb, i64 d,
                          int lane) {
  i64 lo = imax(0, d - nb), hi = imin(d, na);
  while (lo < hi) {
    const i64 n = hi - lo;
    const i64 i = lo + (((i64)lane * n) >> 5);
    const bool p = b[d - i - 1] < a[i];
    const int f = 32 - __popc(__ballot_sync(0xffffffffu, p));
    if (f == 0) {
      hi = lo;  // true at lo already
    } else {
      const i64 base = lo;
      lo = base + (((i64)(f - 1) * n) >> 5) + 1;
      if (f < 32) hi = base + (((i64)f * n) >> 5);
    }
  }
  return lo;
}

// A stream's ring: S keys of shared memory; key i at slot
// (i + phase) mod S. `head` is the slot of key `start`. S is two keys
// more than the span the kernel keeps (window and read-ahead), so that
// a copy widened by one key at each end to 16-byte boundaries writes
// no slot that holds another live key.
template <int S>
struct Ring {
  i64* slots;
  int head;
  i64 start;

  static __device__ __forceinline__ int wrap(int s) {  // 0 <= s < 2S
    return s >= S ? s - S : s;
  }
  __device__ __forceinline__ int slot(i64 i) const {  // |i - start| < S
    const int s = head + (int)(i - start);
    return s < 0 ? s + S : wrap(s);
  }
  __device__ __forceinline__ i64 at(int j) const {  // window row j
    return slots[wrap(head + j)];
  }
  __device__ __forceinline__ void advance(int n) {
    start += n;
    head = wrap(head + n);
  }
  // Thread 0: the 16-byte-aligned key range [c0, c1) to bulk-copy for
  // keys [lo, hi) of src (n keys): lo rounded down and hi rounded up
  // to even (i + phase). A key past either end of src is not read:
  // key 0 or key n - 1 then goes alone by an 8-byte cp.async.
  __device__ void widen(const i64* __restrict__ src, i64 n, int phase,
                        i64 lo, i64 hi, i64& c0, i64& c1) const {
    c0 = c1 = 0;
    if (lo >= hi) return;
    c0 = lo - ((lo + phase) & 1);
    c1 = hi + ((hi + phase) & 1);
    if (c0 < 0) {
      cp_async8(&slots[slot(0)], src);
      c0 = 1;
    }
    if (c1 > n) {
      cp_async8(&slots[slot(n - 1)], src + n - 1);
      c1 = n - 1;
    }
    if (c1 < c0) c1 = c0;
  }
  // Thread 0: bulk-copy keys [c0, c1) into their slots (two copies
  // where the range wraps), completing on `bar`.
  __device__ void copy(const i64* __restrict__ src, i64 c0, i64 c1,
                       uint64_t* bar) const {
    if (c0 >= c1) return;
    const int s0 = slot(c0);
    const int len = (int)(c1 - c0);
    const int first = min(len, S - s0);
    bulk_copy(&slots[s0], src + c0, 8u * first, bar);
    if (len > first) {
      bulk_copy(&slots[0], src + c0 + first, 8u * (len - first), bar);
    }
  }
};

// Thread 0: one fill generation - the keys [fa, fa2) of A and [fb, fb2)
// of B, bulk copies on `bar` (armed with their byte count first) and
// ragged ends as one cp.async group.
template <int S>
__device__ void fill(const Ring<S>& ra, const i64* __restrict__ a, i64 na,
                     int pa, i64 fa, i64 fa2, const Ring<S>& rb,
                     const i64* __restrict__ b, i64 nb, int pb, i64 fb,
                     i64 fb2, uint64_t* bar) {
  i64 a0, a1, b0, b1;
  ra.widen(a, na, pa, fa, fa2, a0, a1);
  rb.widen(b, nb, pb, fb, fb2, b0, b1);
  bar_expect(bar, (unsigned)(8 * ((a1 - a0) + (b1 - b0))));
  ra.copy(a, a0, a1, bar);
  rb.copy(b, b0, b1, bar);
  cp_async_commit();
}

template <int T>
constexpr int stage_bytes(bool member) {
  return member ? (T + 8 + 15) / 16 * 16 : (T + 2) * 8;
}

template <int THREADS, int R, bool MEMBER>
__device__ __forceinline__ void merge_path_tiles(
    const i64* __restrict__ a, i64 na, const i64* __restrict__ b, i64 nb,
    void* out, i64 tiles_per_cta, i64* smem) {
  constexpr int T = THREADS * R;
  constexpr int D = 2;  // ring depth in tiles: the window, one read-ahead
  constexpr int S = D * T + 2;
  static_assert(THREADS % 32 == 0 && (R & 1), "warps of threads, odd R");
  __shared__ i64 s_split[2];
  __shared__ i64 s_halo[2];
  __shared__ int s_has[2];
  __shared__ int s_aused;
  __shared__ __align__(8) uint64_t s_bar[D];  // generation g: s_bar[g % D]

  const i64 m = na + nb;
  const i64 d_beg = (i64)blockIdx.x * tiles_per_cta * T;
  if (d_beg >= m) return;
  const i64 d_end = imin(d_beg + tiles_per_cta * T, m);
  const int t = threadIdx.x;
  if (t == 0) {
    for (int k = 0; k < D; ++k) bar_init(&s_bar[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int w = t >> 5; w < 2; w += THREADS / 32) {
    const i64 s = warp_split(a, na, b, nb, w ? d_end : d_beg, t & 31);
    if ((t & 31) == 0) s_split[w] = s;
  }
  __syncthreads();
  const i64 a1 = s_split[1], b1 = d_end - a1;
  const int pa = (int)(((uintptr_t)a >> 3) & 1);
  const int pb = (int)(((uintptr_t)b >> 3) & 1);
  Ring<S> ra{smem, 0, s_split[0]};
  Ring<S> rb{smem + S, 0, d_beg - s_split[0]};
  ra.head = (int)((ra.start + pa) % S);
  rb.head = (int)((rb.start + pb) % S);
  // generations 0 and 1: the first window, then the read-ahead. Tile k
  // waits for generation k; the refill after tile k is generation k + D.
  i64 fa = imin(ra.start + D * T, a1), fb = imin(rb.start + D * T, b1);
  if (t == 0) {
    if (MEMBER) {
      s_has[0] = ra.start > 0;
      s_halo[0] = ra.start > 0 ? a[ra.start - 1] : 0;
    }
    const i64 wa = imin(ra.start + T, a1), wb = imin(rb.start + T, b1);
    fill(ra, a, na, pa, ra.start, wa, rb, b, nb, pb, rb.start, wb,
         &s_bar[0]);
    fill(ra, a, na, pa, wa, fa, rb, b, nb, pb, wb, fb, &s_bar[1]);
  }

  i64* stage = smem + 2 * S;  // merge: out row r at slot r + sh
  unsigned char* flags = (unsigned char*)(smem + 2 * S);
  const uintptr_t out_addr = (uintptr_t)out;
  int par = 0, tile = 0;
  for (i64 d0 = d_beg; d0 < d_end; d0 += T, par ^= 1, ++tile) {
    if (t == 0) cp_async_wait<D - 1>();
    bar_wait(&s_bar[tile % D], (tile / D) & 1);
    __syncthreads();
    const int na_w = (int)imin(T, a1 - ra.start);
    const int nb_w = (int)imin(T, b1 - rb.start);
    const int rows = (int)imin(T, d_end - d0);
    // this thread's diagonal, searched in the windows
    const int d = min(t * R, rows);
    int lo = max(0, d - nb_w), hi = min(d, na_w);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rb.at(d - mid - 1) < ra.at(mid)) hi = mid; else lo = mid + 1;
    }
    int ia = lo, ib = d - lo;
    const int e = min(d + R, rows);
    // the next key of each side (past a window's end: never taken)
    i64 va = ra.at(ia), vb = rb.at(ib);
    const int sh = MEMBER ? (int)((out_addr + rb.start) & 3)
                          : (int)(((out_addr >> 3) + d0) & 1);
    i64 last = 0;
    bool has = false;
    if (MEMBER) {
      has = ia > 0 || s_has[par];
      last = ia > 0 ? ra.at(ia - 1) : s_halo[par];
    }
    // the serial merge, without branches: one compare, one store and
    // one shared-memory load (the taken side's next key) a row
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (d + k < e) {
        const bool take_a = ia < na_w && (ib >= nb_w || va <= vb);
        if (MEMBER) {
          if (!take_a) flags[ib + sh] = has && last == vb;
          last = take_a ? va : last;
          has = has || take_a;
        } else {
          stage[d + k + sh] = take_a ? va : vb;
        }
        ia += take_a;
        ib += !take_a;
        const int j = take_a ? ra.head + ia : S + rb.head + ib;
        const int jw = j >= (take_a ? S : 2 * S) ? j - S : j;
        const i64 next = smem[jw];
        va = take_a ? next : va;
        vb = take_a ? vb : next;
      }
    }
    if (d < rows && e == rows) {  // the thread that merges the last row
      s_aused = ia;
      if (MEMBER) {
        s_halo[par ^ 1] = last;
        s_has[par ^ 1] = has;
      }
    }
    __syncthreads();
    const int a_used = s_aused, b_used = rows - a_used;
    const i64 q0 = rb.start;
    ra.advance(a_used);
    rb.advance(b_used);
    // refill the consumed slots; they land while the next tiles merge
    {
      const i64 fa2 = imin(ra.start + D * T, a1);
      const i64 fb2 = imin(rb.start + D * T, b1);
      if (t == 0) {
        fill(ra, a, na, pa, fa, fa2, rb, b, nb, pb, fb, fb2,
             &s_bar[tile % D]);
      }
      fa = fa2;
      fb = fb2;
    }
    if (MEMBER) {
      // query q0 + j's flag at flags[j + sh]; words where out is 4-aligned
      unsigned char* g = (unsigned char*)out + q0;
      const int h = min((4 - sh) & 3, b_used);
      const int words = (b_used - h) >> 2;
      const int tail = h + 4 * words;
      if (t < h) g[t] = flags[t + sh];
      if (t < b_used - tail) g[tail + t] = flags[tail + t + sh];
      for (int k = t; k < words; k += THREADS) {
        const int j = h + 4 * k;
        *(unsigned*)(g + j) = *(const unsigned*)(flags + j + sh);
      }
    } else {
      // row r at stage[r + sh]; pairs where out + d0 + r is 16-aligned
      i64* g = (i64*)out + d0;
      const int p0 = sh;
      const int pairs = (rows - p0) >> 1;
      const int p1 = p0 + 2 * pairs;
      if (p0 && t == 0) g[0] = stage[sh];
      if (p1 < rows && t == THREADS - 1) g[p1] = stage[p1 + sh];
      for (int k = t; k < pairs; k += THREADS) {
        const int r = p0 + 2 * k;
        *(longlong2*)(g + r) = *(const longlong2*)(stage + r + sh);
      }
    }
  }
  // no copy may land after the CTA exits
  for (int g = tile; g < tile + D; ++g) {
    bar_wait(&s_bar[g % D], (g / D) & 1);
  }
  if (t == 0) cp_async_wait<0>();
}

// The kernels. Each count is a value or, where its pointer is not null,
// one int64 in device memory that the kernel reads (then the value is
// the buffer's capacity, which the live length never exceeds). The grid
// is sized on the host to the values: at most the CTAs the card holds
// at once, never more than tiles. Each CTA takes ceil(tiles / gridDim.x)
// tiles of the live length, so the tiles spread over the whole grid
// whatever the live length; CTAs past it exit. A side with no keys is a
// copy of the other (merge) or all-false flags (member), by a
// grid-stride loop, so the tiles never meet an empty side.
template <int THREADS, int R>
__global__ void __launch_bounds__(THREADS)
    merge_tile_kernel(const i64* __restrict__ a,
                      const i64* __restrict__ na_p, i64 na,
                      const i64* __restrict__ b,
                      const i64* __restrict__ nb_p, i64 nb, i64* out) {
  extern __shared__ __align__(16) i64 smem[];
  if (na_p != nullptr) na = *na_p;
  if (nb_p != nullptr) nb = *nb_p;
  if (na == 0 || nb == 0) {
    const i64* src = na == 0 ? b : a;
    const i64 n = na + nb;
    for (i64 i = (i64)blockIdx.x * THREADS + threadIdx.x; i < n;
         i += (i64)gridDim.x * THREADS) {
      out[i] = src[i];
    }
    return;
  }
  constexpr int T = THREADS * R;
  const i64 tiles = (na + nb + T - 1) / T;
  const i64 per_cta = (tiles + gridDim.x - 1) / gridDim.x;
  merge_path_tiles<THREADS, R, false>(a, na, b, nb, out, per_cta, smem);
}

template <int THREADS, int R>
__global__ void __launch_bounds__(THREADS)
    member_tile_kernel(const i64* __restrict__ a,
                       const i64* __restrict__ na_p, i64 na,
                       const i64* __restrict__ q,
                       const i64* __restrict__ nq_p, i64 nq,
                       unsigned char* out) {
  extern __shared__ __align__(16) i64 smem[];
  if (na_p != nullptr) na = *na_p;
  if (nq_p != nullptr) nq = *nq_p;
  if (na == 0 || nq == 0) {
    for (i64 i = (i64)blockIdx.x * THREADS + threadIdx.x; i < nq;
         i += (i64)gridDim.x * THREADS) {
      out[i] = 0;
    }
    return;
  }
  constexpr int T = THREADS * R;
  const i64 tiles = (na + nq + T - 1) / T;
  const i64 per_cta = (tiles + gridDim.x - 1) / gridDim.x;
  merge_path_tiles<THREADS, R, true>(a, na, q, nq, out, per_cta, smem);
}

// How many CTAs of `kernel` (THREADS threads, `smem` bytes) the card
// holds at once, asked once per device and kernel (0: an error, in err).
template <int THREADS>
i64 resident_ctas(const void* kernel, int smem, int* cache,
                  cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return 0;
  if (dev >= 64) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (cache[dev] == 0) {
    *err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (*err != cudaSuccess) return 0;
    int sms = 0, per_sm = 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         THREADS, smem);
    if (*err != cudaSuccess) return 0;
    cache[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  return cache[dev];
}

template <int THREADS, int R, bool MEMBER>
cudaError_t launch(const i64* a, const i64* na_p, i64 na, const i64* b,
                   const i64* nb_p, i64 nb, void* out, cudaStream_t stream) {
  constexpr int T = THREADS * R;
  constexpr int smem =
      2 * (2 * T + 2) * (int)sizeof(i64) + stage_bytes<T>(MEMBER);
  const void* kernel = MEMBER ? (const void*)member_tile_kernel<THREADS, R>
                              : (const void*)merge_tile_kernel<THREADS, R>;
  // per device: how many CTAs the card holds at once (0 = not asked yet)
  static int resident[64];
  cudaError_t err = cudaSuccess;
  const i64 slots = resident_ctas<THREADS>(kernel, smem, resident, &err);
  if (err != cudaSuccess) return err;
  const i64 tiles = (na + nb + T - 1) / T;
  const i64 grid = tiles < slots ? (tiles > 0 ? tiles : 1) : slots;
  if (MEMBER) {
    member_tile_kernel<THREADS, R><<<(unsigned)grid, THREADS, smem, stream>>>(
        a, na_p, na, b, nb_p, nb, (unsigned char*)out);
  } else {
    merge_tile_kernel<THREADS, R><<<(unsigned)grid, THREADS, smem, stream>>>(
        a, na_p, na, b, nb_p, nb, (i64*)out);
  }
  return cudaGetLastError();
}

// Tile shapes (rows = THREADS * R); ops/merge.py TILES lists the same.
template <bool MEMBER>
int dispatch(const void* a, const void* na_p, i64 na, const void* b,
             const void* nb_p, i64 nb, void* out, i64 tile, void* stream) {
  const i64* pa = (const i64*)a;
  const i64* pb = (const i64*)b;
  const i64* ca = (const i64*)na_p;
  const i64* cb = (const i64*)nb_p;
  cudaStream_t s = (cudaStream_t)stream;
  // one line a case: tests/test_torch_merge_tiles.py reads the table
  switch (tile) {
    case 32: return (int)launch<32, 1, MEMBER>(pa, ca, na, pb, cb, nb, out, s);
    case 1664: return (int)launch<128, 13, MEMBER>(pa, ca, na, pb, cb, nb, out, s);
    case 2304: return (int)launch<256, 9, MEMBER>(pa, ca, na, pb, cb, nb, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points (bound with ctypes). Every pointer is device memory on
// the caller's stream; keys are 8-byte aligned. One kernel launch each;
// both return cudaGetLastError() after it (cudaErrorInvalidValue for a
// tile size not listed in `dispatch`).
//
// na and nb (nq) are the live lengths, or, where na_p and nb_p (nq_p)
// are not null, the capacities of a and b, with the live lengths in the
// one int64 each pointer points at, read by the kernel: then no host
// read is needed, and the launch stays valid in a CUDA graph replayed
// with other counts. out holds at least na + nb rows (merge) or nb flags
// (member), of the values; only rows [0, na + nb) of out (flags [0, nq))
// of the live lengths are written. Either length may be 0.

extern "C" int stpu_merge_sorted(const void* a, const void* na_p, i64 na,
                                 const void* b, const void* nb_p, i64 nb,
                                 void* out, i64 tile, void* stream) {
  return dispatch<false>(a, na_p, na, b, nb_p, nb, out, tile, stream);
}

extern "C" int stpu_member_sorted(const void* a, const void* na_p, i64 na,
                                  const void* q, const void* nq_p, i64 nq,
                                  void* out, i64 tile, void* stream) {
  return dispatch<true>(a, na_p, na, q, nq_p, nq, out, tile, stream);
}
