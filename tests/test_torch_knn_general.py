"""The general and packed kNN kernel (`csrc/knn_general.cu`) emulated on
the CPU, step for step of its decomposition: the key splits' ranges of
64-key tiles, each tile's survivors (keys below their row's current k-th)
taken in an arbitrary order, as the kernel's shared atomics leave them,
each split's partial list (in two lanes' registers up to k = 64, a bound
from the first tile keeping most of its keys out; past it in memory, the
warp merging a row's batch 32 keys at a time by rank), and the last split
to arrive merging the others' lists into its own by key.  The keys are the kernel's: each norm
and inner product one fma chain over the channels in order, in both modes
(exact bits(d) << 32 | col, packed (bits(d) & ~low) | col).

Held exactly: to one full sort of the same keys (keys are unique within a
row, so the k smallest are one set in one order whatever order they
arrive in: the ground of the kernel's bits being the earlier kernel's), to
the plain `knn_reference` / `knn_packed_reference` on integer points
(every product and sum exact in f32), and to the JAX package's
`knn_indices_pallas` kernel in interpret mode on integer points."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu_torch.ops import cuda_knn
from torch_port_helpers import jax_knn_kernel

TILE = cuda_knn.ROWS          # keys per staged tile
REG_K = 64                    # lists in registers up to this k (csrc/knn_general.cu kMaxRegK)
BATCH = 32                    # keys a sorted merge takes at once (a warp)


def none_key(packed: bool) -> np.uint64:
    """The kernel's empty slot: ~0 of its key type, above every real key."""
    return np.uint64(0xFFFFFFFF if packed else 0xFFFFFFFFFFFFFFFF)


def fma_chain_keys(x: np.ndarray, packed: bool) -> np.ndarray:
    """x (B, N, C) f32 -> (B, N, N) uint64, the kernel's keys: each norm and
    inner product one fma chain from 0 over the channels in order (the
    product exact in f64, each step rounded to f32); d = max((qq - 2 inner)
    + kk, 0) packed, max((qq + kk) - 2 inner, 0) exact."""
    n = x.shape[1]
    xd = x.astype(np.float64)
    nrm = np.zeros(x.shape[:2], np.float32)
    inner = np.zeros((x.shape[0], n, n), np.float32)
    for ch in range(x.shape[2]):
        v = xd[:, :, ch]
        nrm = (v * v + nrm).astype(np.float32)
        inner = (v[:, :, None] * v[:, None, :] + inner).astype(np.float32)
    two = np.float32(2) * inner
    qq, kk = nrm[:, :, None], nrm[:, None, :]
    col = np.arange(n, dtype=np.uint64)
    if packed:
        d = np.maximum((qq - two) + kk, np.float32(0))
        low = (1 << cuda_knn.packed_bits(n)) - 1
        return (d.view(np.uint32) & np.uint32(0xFFFFFFFF ^ low)).astype(np.uint64) | col
    d = np.maximum((qq + kk) - two, np.float32(0))
    return (d.view(np.uint32).astype(np.uint64) << np.uint64(32)) | col


class RegisterLists:
    """Every row's list for k <= 64 (`List` in the kernel): K = 2 H slots,
    the largest first, slots 0 .. H - 1 in the upper lane, H .. K - 1 in the
    lower; empty real slots ~0, slots past k 0 (nothing is below them)."""

    def __init__(self, rows: int, k: int, none: np.uint64):
        h = next(s for s in (8, 20, 32, 48, REG_K) if k <= s) // 2
        self.k, self.h = k, h
        fill = lambda base: np.where(base + np.arange(h) < k, none, np.uint64(0))  # noqa: E731
        self.up = np.tile(fill(0), (rows, 1))
        self.lo = np.tile(fill(h), (rows, 1))

    def top(self) -> np.ndarray:
        return self.up[:, 0]

    @staticmethod
    def _insert(v: np.ndarray, x: np.ndarray, on: np.ndarray) -> None:
        """x replaces slot 0 of the rows `on` and sinks by the fixed chain."""
        for s in range(v.shape[1] - 1):
            nx = v[:, s + 1]
            sink = x < nx
            v[:, s] = np.where(on, np.where(sink, nx, x), v[:, s])
            x = np.where(sink, x, nx)
        v[:, -1] = np.where(on, x, v[:, -1])

    def offer(self, x: np.ndarray) -> None:
        """x (rows,): each row's candidate (~0: nothing), as `List.offer`."""
        below = x < self.lo[:, 0]
        up = np.where(below, self.lo[:, 0], x)
        enter = x < self.top()
        self._insert(self.lo, x, enter & below)
        self._insert(self.up, up, enter)

    def keys(self) -> np.ndarray:
        """(rows, k), ascending: slots k - 1 .. 0."""
        return np.concatenate([self.up, self.lo], axis=1)[:, :self.k][:, ::-1].copy()


def merge_batch(lst: np.ndarray, cand: np.ndarray, none: np.uint64) -> None:
    """`merge_batch`: up to 32 candidates into one row's ascending list of
    k keys, in place.  Those below the k-th enter at their rank in the
    batch plus their rank in the list; each list key above the batch's
    least moves up by the number of batch keys below it, from the top down
    in steps of 32, each step read in full before it is written."""
    k = len(lst)
    c = cand[cand < lst[-1]]
    if not len(c):
        return
    rank = np.argsort(np.argsort(c))
    lo = np.searchsorted(lst, c, side="left")
    srt = np.sort(c)
    p0 = int(lo[rank == 0][0])
    length = k if lst[-1] != none else p0 + int(np.argmax(lst[p0:] == none))
    top = min(k - 1, length)
    while top > p0:
        i = np.arange(top - 1, max(p0, top - 32) - 1, -1)
        v = lst[i].copy()
        to = i + np.searchsorted(srt, v, side="left")
        lst[to[to < k]] = v[to < k]
        top -= 32
    pos = lo + rank
    lst[pos[pos < k]] = c[pos < k]


def first_tile_bound(tile: np.ndarray, k: int, none: np.uint64) -> np.ndarray:
    """`first_tile_bound` for every row, as a threshold: lane t of a row
    holds the tile's keys t + 8 j (~0 past them) and takes the m-th
    smallest, m = ceil(k / 8); one above the largest over the 8 lanes, ~0
    where that is ~0."""
    full = np.full((tile.shape[0], TILE), none, np.uint64)
    full[:, :tile.shape[1]] = tile
    lanes = np.sort(full.reshape(-1, 8, 8), axis=1)          # [row, j, t], sorted over j
    b = lanes[:, (k + 7) // 8 - 1, :].max(axis=1)
    return np.where(b == none, none, b + np.uint64(1))


def scan(keys: np.ndarray, start: int, end: int, k: int, none: np.uint64,
         rng: np.random.Generator) -> np.ndarray:
    """One split's scan of keys [start, end) of every row of a cloud:
    (rows, N) keys -> (rows, k) ascending, ~0 where the split holds fewer
    than k keys."""
    rows = keys.shape[0]
    reg = RegisterLists(rows, k, none) if k <= REG_K else None
    lists = None if reg else np.full((rows, k), none, np.uint64)
    for key0 in range(start, end, TILE):
        tile = keys[:, key0:min(end, key0 + TILE)]
        thr = reg.top() if reg else lists[:, -1]
        if reg and key0 == start:
            thr = np.minimum(thr, first_tile_bound(tile, k, none))
        tile = tile[:, rng.permutation(tile.shape[1])]        # the atomics' order
        alive = tile < thr[:, None]
        batch = np.where(alive, tile, none)
        batch = np.take_along_axis(batch, np.argsort(~alive, axis=1, kind="stable"), axis=1)
        if reg:
            for it in range(int(alive.sum(1).max(initial=0))):
                reg.offer(batch[:, it])
            continue
        for r in np.nonzero(alive.any(1))[0]:
            m = int(alive[r].sum())
            for s0 in range(0, m, BATCH):
                merge_batch(lists[r], batch[r, s0:min(m, s0 + BATCH)], none)
    return reg.keys() if reg else lists


def final_merge(parts: list, last: int, k: int, none: np.uint64) -> np.ndarray:
    """The last split to arrive merges the others' lists into its own, in
    split order, each stopping at the first key not below the k-th."""
    rows = parts[0].shape[0]
    if k <= REG_K:
        reg = RegisterLists(rows, k, none)
        for j in range(k):
            reg.offer(parts[last][:, j])
        for sp, part in enumerate(parts):
            if sp == last:
                continue
            for j in range(k):
                if not (part[:, j] < reg.top()).any():
                    break
                reg.offer(part[:, j])
        return reg.keys()
    lists = parts[last].copy()
    for sp, part in enumerate(parts):
        if sp == last:
            continue
        for r in range(rows):
            for s0 in range(0, k, BATCH):
                if not (part[r, s0:s0 + BATCH] < lists[r, -1]).any():
                    break
                merge_batch(lists[r], part[r, s0:s0 + BATCH], none)
    return lists


def split_ranges(n: int, splits: int) -> list:
    """The kernel's key ranges: ceil(tiles / S) tiles a split, the last ones
    short or empty."""
    tiles = -(-n // TILE)
    per = -(-tiles // splits)
    return [(min(n, s * per * TILE), min(n, (s + 1) * per * TILE)) for s in range(splits)]


def emulate(keys: np.ndarray, k: int, splits: int, packed: bool, seed: int = 0) -> np.ndarray:
    """(B, N, N) keys -> (B, N, k) int32 indices, as the kernel leaves them
    (lists in memory merge alike in shared and in device memory)."""
    none = none_key(packed)
    rng = np.random.default_rng(seed)
    out = []
    for cloud in keys:
        parts = [scan(cloud, a, e, k, none, rng) for a, e in split_ranges(cloud.shape[1], splits)]
        out.append(final_merge(parts, int(rng.integers(splits)), k, none))
    low = (1 << cuda_knn.packed_bits(keys.shape[-1])) - 1 if packed else 0xFFFFFFFF
    return (np.stack(out) & np.uint64(low)).astype(np.int32)


def full_sort(keys: np.ndarray, k: int, packed: bool) -> np.ndarray:
    low = (1 << cuda_knn.packed_bits(keys.shape[-1])) - 1 if packed else 0xFFFFFFFF
    return (np.sort(keys, axis=-1)[..., :k] & np.uint64(low)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _points(n: int, c: int, integer: bool) -> np.ndarray:
    rng = np.random.default_rng(n * 1000 + c + integer)
    if integer:
        return rng.integers(-4, 5, size=(1, n, c)).astype(np.float32)
    x = rng.normal(size=(1, n, c)).astype(np.float32)
    x[0, 11] = x[0, 40]                    # a duplicate point: exact ties
    return x


@functools.lru_cache(maxsize=None)
def _keys(n: int, c: int, integer: bool, packed: bool) -> np.ndarray:
    return fma_chain_keys(_points(n, c, integer), packed)


N = 200   # four key tiles, the last of 8 keys


@pytest.mark.parametrize("packed", [False, True], ids=["exact", "packed"])
@pytest.mark.parametrize("c", [9, 64, 300])
@pytest.mark.parametrize("k", [20, 40, 70])
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_decomposition_equals_full_sort_and_plain(splits, k, c, packed):
    """Register lists (k = 20, and 40 past 32 slots) and lists in memory
    (k = 70, past a tile), channels in one chunk, two and ten (C = 300),
    one to four key splits (four: one tile a split): the lists equal one
    full sort of the same fma-chain keys on normal points with a
    duplicate, and on integer points the plain version."""
    got = emulate(_keys(N, c, False, packed), k, splits, packed, seed=splits + k + c)
    np.testing.assert_array_equal(got, full_sort(_keys(N, c, False, packed), k, packed))
    xi = torch.from_numpy(_points(N, c, True))
    plain = cuda_knn.knn_packed_reference(xi, k) if packed else cuda_knn.knn_reference(xi, k)
    np.testing.assert_array_equal(emulate(_keys(N, c, True, packed), k, splits, packed),
                                  plain.numpy())


@pytest.mark.parametrize("packed", [False, True], ids=["exact", "packed"])
def test_decomposition_equals_pallas_interpret_on_integer_points(packed):
    """At N = 128, C = 9, k = 40, two key splits: the emulated kernel equals
    `knn_indices_pallas`'s kernel in interpret mode (exact and packed keys)
    on integer points."""
    x = _points(128, 9, True)
    want = np.asarray(jax_knn_kernel(jnp.asarray(x), 40, 32, exact=not packed))
    np.testing.assert_array_equal(emulate(fma_chain_keys(x, packed), 40, 2, packed), want)


def test_split_ranges_and_merge_edges():
    """The ranges cover the keys once in order (empty splits at the end
    where S does not divide the tiles), and a sorted merge keeps the k
    smallest of the list and the batch: into an empty list, a full one, a
    batch all below the list, all above it, and one key."""
    assert split_ranges(200, 4) == [(0, 64), (64, 128), (128, 192), (192, 200)]
    assert split_ranges(130, 4) == [(0, 64), (64, 128), (128, 130), (130, 130)]
    assert split_ranges(2048, 4)[-1] == (1536, 2048)
    none = none_key(True)
    rng = np.random.default_rng(1)
    for k, have, m in ((40, 0, 32), (40, 40, 32), (70, 65, 20), (33, 33, 1), (40, 10, 5)):
        pool = rng.choice(1 << 20, size=have + m, replace=False).astype(np.uint64)
        for cand in (pool[have:], np.sort(pool)[:m], np.sort(pool)[-m:]):
            rest = np.setdiff1d(pool, cand)
            lst = np.full(k, none, np.uint64)
            lst[:len(rest)] = np.sort(rest)
            want = np.sort(np.concatenate([lst, cand]))[:k]
            merge_batch(lst, cand, none)
            np.testing.assert_array_equal(lst, want)
