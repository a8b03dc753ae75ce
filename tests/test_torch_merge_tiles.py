"""The index math of the CUDA Merge Path kernels
(stateright_tpu_torch/csrc/merge_path.cu), emulated on the CPU.

The kernels run only on the card; this file keeps a plain-Python copy
of what each CTA of ``merge_path_tiles`` does and runs it on small
inputs:

* the persistent grid (``launch``): tiles of T = threads * R rows, at
  most the resident CTAs and never more CTAs than tiles of the buffers
  (a call with device counts sizes the grid to the capacities), a run of
  ceil(tiles / grid) live tiles for each CTA, the CTAs past them idle;
* the two diagonals at the ends of a CTA's run, found by the
  warp-cooperative search (32 probes and one ballot a step), held
  against the plain partition ``merge_path_starts_keys``;
* the two shared-memory rings: slot (i + phase) mod (2T + 2), TMA
  copies widened to 16-byte boundaries and split where the ring wraps
  (8-byte copies at the ends of A and B), fill generations that land
  only when the tile that needs them waits (a read of a slot whose copy
  has not landed, or holds another key, fails), every key read from
  device memory, and at most the widened keys twice;
* per thread: the diagonal search in the windows and the serial merge
  of its R rows; the member halo carried from tile to tile;
* the staged stores: 16-byte pairs (merge) or 4-byte words (member)
  where the output address is aligned, each output row written once.

The concatenated serial merges must equal numpy's stable merge and the
per-query flags ``np.isin``, on the tie pool with hi limbs at and above
2**31, for a tiny tile (4 threads x 2 rows), the kernel's smallest tile
and the production tile, at sizes k*T - 1, k*T and k*T + 1."""

import numpy as np
import pytest
import torch

SENT64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _packed(vals64):
    """numpy uint64 fingerprints -> sorted packed int64 keys (a list)."""
    from stateright_tpu_torch.ops.fingerprint import pack_keys

    v = np.sort(np.asarray(vals64, np.uint64))
    lo = torch.from_numpy((v & np.uint64(0xFFFFFFFF)).astype(np.int64))
    hi = torch.from_numpy((v >> np.uint64(32)).astype(np.int64))
    return pack_keys(lo, hi).tolist()


def _tie_pool(rng, n):
    hi = rng.integers(0, 4, size=n, dtype=np.uint64) + np.uint64(0x7FFFFFFE)
    hi[: n // 4] = np.uint64(0xFFFFFFFE)
    lo = rng.integers(0, 4, size=n, dtype=np.uint64)
    lo[: n // 8] = np.uint64(0xFFFFFFFF)
    return (hi << np.uint64(32)) | lo


def _warp_split(a, b, d):
    """``warp_split``: the Merge Path split of diagonal d."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        n = hi - lo
        probes = [lo + ((k * n) >> 5) for k in range(32)]
        p = [b[d - i - 1] < a[i] for i in probes]
        assert p == sorted(p)  # the ballot is 0..0 1..1
        f = 32 - sum(p)
        if f == 0:
            hi = lo
        else:
            base = lo
            lo = base + (((f - 1) * n) >> 5) + 1
            if f < 32:
                hi = base + ((f * n) >> 5)
    return lo


class _Ring:
    """``Ring<S>``; copies land only when their generation is waited."""

    def __init__(self, src, phase, start, size, reads):
        self.src, self.phase, self.S = src, phase, size
        self.start, self.head = start, (start + phase) % size
        self.slots = [None] * size  # (key index, key) once landed
        self.reads = reads  # device-memory reads per key index

    def slot(self, i):
        assert abs(i - self.start) < self.S
        return (self.head + (i - self.start)) % self.S

    def at(self, j):
        idx, key = self.slots[(self.head + j) % self.S]
        assert idx == self.start + j, "read a slot before its copy landed"
        return key

    def advance(self, n):
        self.start += n
        self.head = (self.head + n) % self.S

    def fill(self, lo, hi, gen):
        """``widen`` + ``copy``: [lo, hi) widened to 16-byte boundaries,
        one or two bulk copies (split where the ring wraps), an 8-byte
        copy for a key at a ragged end of the source."""
        if lo >= hi:
            return
        n, ph = len(self.src), self.phase
        c0, c1 = lo - ((lo + ph) & 1), hi + ((hi + ph) & 1)
        copies = []  # (first key, keys)
        if c0 < 0:
            copies.append((0, 1))
            c0 = 1
        if c1 > n:
            copies.append((n - 1, 1))
            c1 = n - 1
        if c0 < c1:
            s0, length = self.slot(c0), c1 - c0
            first = min(length, self.S - s0)
            pieces = [(c0, s0, first)]
            if length > first:
                pieces.append((c0 + first, 0, length - first))
            for i, s, k in pieces:
                # TMA: 16-byte aligned in device and shared memory, and
                # a multiple of 16 bytes
                assert (i + ph) % 2 == 0 and s % 2 == 0 and k % 2 == 0
                assert s + k <= self.S
                copies.append((i, k))
        for i, k in copies:
            for j in range(i, i + k):
                self.reads[j] += 1
                gen.append((self.slots, self.slot(j), j, self.src[j]))

def _land(gens, upto):
    """Wait for generations 0..upto (their mbarrier phases)."""
    for g in range(upto + 1):
        for slots, s, idx, key in gens[g]:
            slots[s] = (idx, key)
        gens[g] = []

def _cta(a, b, threads, rows_per, member, per_cta, cta, phases, out,
         written, reads):
    """One CTA of ``merge_path_tiles``; returns its run's two splits."""
    T = threads * rows_per
    depth = 2  # the ring: the window and one tile of read-ahead
    S = depth * T + 2
    pa, pb, po = phases
    m = len(a) + len(b)
    d_beg = cta * per_cta * T
    assert d_beg < m  # an idle CTA exits before this
    d_end = min(d_beg + per_cta * T, m)
    a0, a1 = _warp_split(a, b, d_beg), _warp_split(a, b, d_end)
    b1 = d_end - a1
    ra = _Ring(a, pa, a0, S, reads[0])
    rb = _Ring(b, pb, d_beg - a0, S, reads[1])
    halo = [a[a0 - 1] if a0 > 0 else 0, 0]
    has = [a0 > 0, False]
    gens = [[], []]  # 0: the first window, 1: the read-ahead
    fa, fb = min(ra.start + depth * T, a1), min(rb.start + depth * T, b1)
    wa, wb = min(ra.start + T, a1), min(rb.start + T, b1)
    ra.fill(ra.start, wa, gens[0])
    rb.fill(rb.start, wb, gens[0])
    ra.fill(wa, fa, gens[1])
    rb.fill(wb, fb, gens[1])
    par = 0
    for k, d0 in enumerate(range(d_beg, d_end, T)):
        _land(gens, k)  # tile k waits for generation k
        na_w, nb_w = min(T, a1 - ra.start), min(T, b1 - rb.start)
        rows = min(T, d_end - d0)
        sh = (po + rb.start) & 3 if member else (po + d0) & 1
        stage = {}
        a_used = None
        for t in range(threads):
            d = min(t * rows_per, rows)
            lo, hi = max(0, d - nb_w), min(d, na_w)
            while lo < hi:
                mid = (lo + hi) >> 1
                if rb.at(d - mid - 1) < ra.at(mid):
                    hi = mid
                else:
                    lo = mid + 1
            ia, ib = lo, d - lo
            e = min(d + rows_per, rows)
            last = ra.at(ia - 1) if ia > 0 else halo[par]
            h = ia > 0 or has[par]
            for r in range(d, e):
                take_a = ia < na_w and (ib >= nb_w or ra.at(ia) <= rb.at(ib))
                if member:
                    if take_a:
                        last, h = ra.at(ia), True
                    else:
                        assert ib + sh not in stage
                        stage[ib + sh] = h and last == rb.at(ib)
                else:
                    assert r + sh not in stage
                    stage[r + sh] = ra.at(ia) if take_a else rb.at(ib)
                if take_a:
                    ia += 1
                else:
                    ib += 1
            if d < rows and e == rows:
                assert a_used is None  # one thread merges the last row
                a_used = ia
                halo[par ^ 1], has[par ^ 1] = last, h
        b_used = rows - a_used
        q0 = rb.start
        ra.advance(a_used)
        rb.advance(b_used)
        gens.append([])  # generation k + depth
        fa2 = min(ra.start + depth * T, a1)
        fb2 = min(rb.start + depth * T, b1)
        ra.fill(fa, fa2, gens[-1])
        rb.fill(fb, fb2, gens[-1])
        fa, fb = fa2, fb2
        if member:
            hd = min((4 - sh) & 3, b_used)
            words = (b_used - hd) >> 2
            tail = hd + 4 * words
            spans = [(j, 1) for j in range(hd)]
            spans += [(j, 1) for j in range(tail, b_used)]
            for k in range(words):
                j = hd + 4 * k
                assert (po + q0 + j) % 4 == 0 and (j + sh) % 4 == 0
                spans.append((j, 4))
            base, n_out = q0, b_used
        else:
            p0 = sh
            pairs = (rows - p0) >> 1
            p1 = p0 + 2 * pairs
            spans = [(0, 1)] if p0 else []
            if p1 < rows:
                spans.append((p1, 1))
            for k in range(pairs):
                r = p0 + 2 * k
                assert (po + d0 + r) % 2 == 0 and (r + sh) % 2 == 0
                spans.append((r, 2))
            base, n_out = d0, rows
        for j, n in spans:
            for k in range(n):
                out[base + j + k] = stage[j + k + sh]
                written[base + j + k] += 1
        assert sum(n for _, n in spans) == n_out
        par ^= 1
    _land(gens, len(gens) - 1)
    return a0, a1


def _grid(m, T, resident, cap=0):
    """``launch``'s grid for ``m`` live rows in buffers of ``m + cap``
    rows, and the kernel's tiles a CTA: ``(grid, per_cta)``."""
    grid = max(1, min(-(-(m + cap) // T), resident))
    return grid, -(-(-(-m // T)) // grid)


def _emulate(a, b, threads, rows_per, member, resident, phases, cap=0):
    """The whole launch: ``launch`` picks the grid (for buffers of
    ``cap`` rows past the live ones), then every CTA with live tiles
    runs (in reverse order: CTAs need none); the rest exit."""
    T = threads * rows_per
    m = len(a) + len(b)
    tiles = -(-m // T)
    launched, per_cta = _grid(m, T, resident, cap)
    grid = -(-tiles // per_cta)  # the CTAs with live tiles
    assert grid <= launched
    n_out = len(b) if member else m
    out, written = [None] * n_out, [0] * n_out
    reads = ([0] * len(a), [0] * len(b))
    splits = {}
    for cta in reversed(range(grid)):
        splits[cta] = _cta(a, b, threads, rows_per, member, per_cta, cta,
                           phases, out, written, reads)
    assert written == [1] * n_out, "an output row written != once"
    # every key is read; widening to 16 bytes re-reads at most the key
    # on each side of a fill, so reads stay within 2 keys of a tile
    for r, n in zip(reads, (len(a), len(b))):
        assert min(r, default=1) >= 1
        assert sum(r) - n <= 2 * (tiles + 2 * grid)
    return out, [splits[c][0] for c in range(grid)] + [splits[grid - 1][1]]


def _case(seed, T, k, delta, split):
    """A (and B or Q) from the tie pool plus sentinel tails, with
    m = k*T + delta rows; ``split`` picks how many go to A."""
    rng = np.random.default_rng(seed)
    m = max(1, k * T + delta)
    pool = _tie_pool(rng, 40)
    if split == "a-then-b":  # all A keys below all B: all-A, all-B tiles
        na = m // 2
        a = np.sort(rng.choice(pool[pool < np.uint64(1 << 63)], na))
        b = np.sort(rng.choice(pool[pool >= np.uint64(1 << 63)], m - na))
    else:
        na = int(rng.integers(0, m + 1)) if split == "random" else 1
        a = rng.choice(pool, na)
        b = rng.choice(pool, m - na)
        a[rng.random(na) < 0.05] = SENT64
        b[rng.random(m - na) < 0.05] = SENT64
    return _packed(a), _packed(b)


def _tiles(member):
    """(threads, rows a thread): tiny, the kernel's smallest tile, the
    production tile of the member or the merge kernel."""
    from stateright_tpu_torch.ops.merge import (
        MEMBER_BLOCK,
        MERGE_BLOCK,
        TILES,
    )

    production = TILES[MEMBER_BLOCK if member else MERGE_BLOCK]
    return [(4, 2), TILES[min(TILES)], production]


@pytest.mark.parametrize("member", [False, True], ids=["merge", "member"])
@pytest.mark.parametrize("shape", [0, 1, 2], ids=["tiny4x2", "smallest",
                                                  "production"])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_tile_math_equals_numpy(member, shape, delta):
    from stateright_tpu_torch.ops.merge import merge_path_starts_keys

    threads, rows_per = _tiles(member)[shape]
    T = threads * rows_per
    k = 2 if shape == 2 else 5
    for trial, (split, resident, phases, cap) in enumerate([
        ("random", 2, (0, 0, 0), 0),
        ("random", 1 << 20, (1, 0, 3), 0),
        ("a-then-b", 3, (0, 1, 1), 0),
        ("one-a", 2, (1, 1, 2), 0),
        # device counts: the grid sized to buffers of 7 tiles more
        ("random", 1 << 20, (0, 1, 2), 7 * T),
        ("a-then-b", 4, (1, 0, 1), 3 * T),
    ]):
        a, b = _case(100 * shape + 10 * (delta + 1) + trial, T, k, delta,
                     split)
        got, splits = _emulate(a, b, threads, rows_per, member, resident,
                               phases, cap)
        if member:
            want = np.isin(np.array(b), np.array(a)).tolist()
        else:
            want = np.sort(np.array(a + b), kind="stable").tolist()
        assert got == want, (split, resident, phases)
        # the CTA run diagonals are the plain partition's
        m = len(a) + len(b)
        run = _grid(m, T, resident, cap)[1] * T
        plain = merge_path_starts_keys(torch.tensor(a, dtype=torch.int64),
                                       torch.tensor(b, dtype=torch.int64),
                                       run).tolist()
        assert splits == plain


def test_one_key_and_halo_across_tiles():
    """One key on each side; and a run of equal keys that crosses tile
    boundaries with A's copy of the key only in an earlier tile: the
    queries after it find it through the halo."""
    got, _ = _emulate([5], [5], 4, 2, True, 4, (0, 0, 0))
    assert got == [True]
    got, _ = _emulate([5], [7], 4, 2, False, 4, (1, 1, 1))
    assert got == [5, 7]
    a = [1, 2, 3, 9]
    q = [9] * 30 + [10]
    for resident in (1, 2, 64):
        got, _ = _emulate(a, q, 4, 2, True, resident, (0, 1, 2))
        assert got == [True] * 30 + [False]


def test_tile_table_matches_the_kernel_source():
    """ops/merge.py TILES is the table csrc/merge_path.cu dispatches on,
    every shape meets the kernel's static_assert (whole warps, odd rows
    a thread), and both defaults are in it."""
    import re
    from pathlib import Path

    from stateright_tpu_torch.ops import merge

    src = (Path(merge.__file__).resolve().parent.parent / "csrc"
           / "merge_path.cu").read_text()
    cases = re.findall(
        r"case (\d+): return \(int\)launch<(\d+), (\d+), MEMBER>", src)
    table = {int(c): (int(t), int(r)) for c, t, r in cases}
    assert table == merge.TILES
    for rows, (threads, per) in merge.TILES.items():
        assert rows == threads * per
        assert threads % 32 == 0 and per % 2 == 1
    assert merge.MEMBER_BLOCK in merge.TILES
    assert merge.MERGE_BLOCK in merge.TILES
