// Merge Path kernels for the sorted visited set (sm_90a).
//
// Keys are packed int64 sort keys (stateright_tpu_torch/ops/fingerprint.py
// pack_keys): the u64 fingerprint with its top bit flipped, so a signed
// compare orders like the unsigned (hi, lo) pair and the all-ones
// sentinel is INT64_MAX. Both inputs of every kernel are sorted
// ascending; ties order A first.
//
// Shared partition (merge_path_partition_kernel): the merged sequence
// of A and B (or Q) is cut into `block`-row output tiles; for each cut
// d = g * block one thread binary-searches the Merge Path diagonal for
// starts[g], the number of A rows among the first d merged rows (A
// first on ties). Tile g then merges A[starts[g], starts[g+1]) with
// the B rows [g*block - starts[g], (g+1)*block - starts[g+1]). This is
// `merge_path_starts` (stateright_tpu/ops/merge.py:202), which the JAX
// package ran as plain XLA ahead of both Pallas kernels.
//
// merge_tile_kernel replaces the Pallas `_merge_kernel`
// (stateright_tpu/ops/merge.py:232, pallas_call at :343). The Pallas
// tile ranks every window row by a [block, block] broadcast compare and
// places it by a one-hot reduce: work shaped for the TPU vector unit.
// Here one CTA owns one output tile: it stages the tile's A and B
// windows (at most `block` keys each, 8 KB at block 512) in shared
// memory, and thread t takes A row t and B row t. Each finds its rank
// in the other window by binary search (strict < for an A row against
// B, <= for a B row against A, which puts A first on ties) and writes
// its key straight to out[d0 + t + rank]. Every tile writes only its
// own output rows, so CTAs need no order.
//
// member_tile_kernel replaces the Pallas `_member_kernel`
// (stateright_tpu/ops/merge.py:282, pallas_call at :373). A query q is
// in A iff the last A key merged before q (A first on ties: the largest
// A key <= q) equals q. Merge Path puts that key in the tile's A window
// or, when no window key is <= q, at A[a_s - 1]: the halo. One CTA
// stages the window with its halo and each query binary-searches it.
// The Pallas store wrote `block` rows from the tile's first query and
// relied on later grid steps overwriting the overrun: correct only
// under the TPU's sequential grid. Here each tile writes ONLY its own
// query range [q_s, q_e), so CTAs run in any order.
//
// Bound: both kernels are bound by device-memory bytes. Merge reads
// each input key once and writes each output key once, 16 bytes per
// merged row; member reads A and Q once (8 bytes a key) and writes one
// byte a query. The windows are read from device memory once per tile
// (the halo and the partition's log2(Na) probes per tile are
// negligible), and the searches run in shared memory. Staging is
// plain coalesced loads; TMA or cp.async staging, persistent CTAs and
// larger tiles are later work.

#include <cuda_runtime.h>

typedef long long i64;

__global__ void merge_path_partition_kernel(const i64* __restrict__ a,
                                            i64 na,
                                            const i64* __restrict__ b,
                                            i64 nb, i64 block, i64 g_last,
                                            i64* __restrict__ starts) {
  i64 g = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (g > g_last) return;
  i64 m = na + nb;
  i64 d = g * block < m ? g * block : m;
  i64 lo = d - nb > 0 ? d - nb : 0;
  i64 hi = d < na ? d : na;
  while (lo < hi) {
    i64 mid = (lo + hi) >> 1;
    // the split is <= mid iff b[d - mid - 1] merges before a[mid]
    if (b[d - mid - 1] < a[mid]) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  starts[g] = lo;
}

__global__ void merge_tile_kernel(const i64* __restrict__ a, i64 na,
                                  const i64* __restrict__ b, i64 nb,
                                  const i64* __restrict__ starts,
                                  i64* __restrict__ out) {
  extern __shared__ i64 smem[];
  const int block = blockDim.x;
  i64* aw = smem;
  i64* bw = smem + block;
  const i64 g = blockIdx.x;
  const i64 d0 = g * block;
  const i64 m = na + nb;
  const int rows = (int)(m - d0 < block ? m - d0 : block);
  const i64 a_s = starts[g];
  const int a_cnt = (int)(starts[g + 1] - a_s);
  const int b_cnt = rows - a_cnt;
  const i64 b_s = d0 - a_s;
  const int t = threadIdx.x;
  if (t < a_cnt) aw[t] = a[a_s + t];
  if (t < b_cnt) bw[t] = b[b_s + t];
  __syncthreads();
  if (t < a_cnt) {
    const i64 v = aw[t];
    int lo = 0, hi = b_cnt;  // B keys strictly below v
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (bw[mid] < v) lo = mid + 1; else hi = mid;
    }
    out[d0 + t + lo] = v;
  }
  if (t < b_cnt) {
    const i64 v = bw[t];
    int lo = 0, hi = a_cnt;  // A keys at or below v
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (aw[mid] <= v) lo = mid + 1; else hi = mid;
    }
    out[d0 + t + lo] = v;
  }
}

__global__ void member_tile_kernel(const i64* __restrict__ a, i64 na,
                                   const i64* __restrict__ q, i64 nq,
                                   const i64* __restrict__ starts,
                                   unsigned char* __restrict__ out) {
  extern __shared__ i64 smem[];  // smem[0] = halo, smem[1 + i] = window
  const int block = blockDim.x;
  const i64 g = blockIdx.x;
  const i64 d0 = g * block;
  const i64 m = na + nq;
  const int rows = (int)(m - d0 < block ? m - d0 : block);
  const i64 a_s = starts[g];
  const int a_cnt = (int)(starts[g + 1] - a_s);
  const int q_cnt = rows - a_cnt;
  const i64 q_s = d0 - a_s;
  const int t = threadIdx.x;
  if (t < a_cnt) smem[1 + t] = a[a_s + t];
  if (t == 0) smem[0] = a_s > 0 ? a[a_s - 1] : 0;
  __syncthreads();
  if (t < q_cnt) {
    const i64 v = q[q_s + t];
    int lo = 0, hi = a_cnt;  // window keys at or below v
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (smem[1 + mid] <= v) lo = mid + 1; else hi = mid;
    }
    // smem[lo] is the largest A key <= v: window row lo - 1, or the
    // halo when lo == 0 (absent when the window starts A)
    out[q_s + t] = (lo > 0 || a_s > 0) && smem[lo] == v;
  }
}

static cudaError_t launch_partition(const i64* a, i64 na, const i64* b,
                                    i64 nb, i64 block, i64 tiles,
                                    i64* starts, cudaStream_t stream) {
  const int threads = 256;
  const i64 grid = (tiles + 1 + threads - 1) / threads;
  merge_path_partition_kernel<<<(unsigned)grid, threads, 0, stream>>>(
      a, na, b, nb, block, tiles, starts);
  return cudaGetLastError();
}

// C entry points (bound with ctypes). Every pointer is device memory on
// the caller's stream; `starts` is scratch of tiles + 1 int64 rows, with
// tiles = ceil((na + nb) / block). Both return cudaGetLastError() after
// their launches; the caller checks na > 0 and nb > 0 and
// 1 <= block <= 1024.

extern "C" int stpu_merge_sorted(const void* a, i64 na, const void* b,
                                 i64 nb, void* starts, void* out, i64 block,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const i64 tiles = (na + nb + block - 1) / block;
  cudaError_t err = launch_partition((const i64*)a, na, (const i64*)b, nb,
                                     block, tiles, (i64*)starts, s);
  if (err != cudaSuccess) return (int)err;
  merge_tile_kernel<<<(unsigned)tiles, (unsigned)block,
                      2 * block * sizeof(i64), s>>>(
      (const i64*)a, na, (const i64*)b, nb, (const i64*)starts, (i64*)out);
  return (int)cudaGetLastError();
}

extern "C" int stpu_member_sorted(const void* a, i64 na, const void* q,
                                  i64 nq, void* starts, void* out,
                                  i64 block, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const i64 tiles = (na + nq + block - 1) / block;
  cudaError_t err = launch_partition((const i64*)a, na, (const i64*)q, nq,
                                     block, tiles, (i64*)starts, s);
  if (err != cudaSuccess) return (int)err;
  member_tile_kernel<<<(unsigned)tiles, (unsigned)block,
                       (block + 1) * sizeof(i64), s>>>(
      (const i64*)a, na, (const i64*)q, nq, (const i64*)starts,
      (unsigned char*)out);
  return (int)cudaGetLastError();
}
