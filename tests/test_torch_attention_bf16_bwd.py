"""Kernel 5's bf16 form at D <= 64 (`csrc/attention_bwd_bf16.cu`: wgmma
tiles, dS kept once in bf16, the query tiles of a key block cut over the
blocks of a thread block cluster) emulated on the CPU, and the emulation
held against the port's plain version and the JAX package's Pallas kernel
in interpret mode.  Inputs are made from seeds with numpy.

The emulation repeats the kernels' arithmetic and their order of sums:
- the prep pass: Delta = rowsum(bf16(dY) * Y), bf16(dY), the scaled query
  qs = bf16(q * bf16(1 / tau)); channels zero past D up to the next
  multiple of 16 (wgmma's k-depth), rows zero past N up to whole tiles of
  64;
- the dK/dV launch of `bwd_bf16_plan`: a key tile of 64 per cluster, its
  query tiles of 64 dealt to the C = 2 blocks as contiguous ranges; per query
  tile S^T = K qs^T and dPd^T = V dY^T in f32, P^T = exp2((S^T - lse) log2
  e), 0 past N, Pd^T = P^T M, dS^T = P^T (dPd^T M - Delta), dV += bf16(Pd^T)
  bf16(dY) and dK += bf16(dS^T) q in each block's partials, which are then
  added in rank order, dK times the f32 1 / tau;
- bf16(dS^T) written to the scratch at `bwd_bf16_ds_offset`;
- the dQ launch: per query tile, the key tiles in order, dQ += bf16(dS) K
  from the scratch, times 1 / tau.
exp2 is torch's and the products' f32 sums run in torch's order (the
card's ex2.approx and wgmma sum otherwise), so the emulation is held to the
card's gate: each gradient within ATTN_BF16_BWD_TOL of its largest entry.
The index tests check the plan (every (cloud, key tile, query tile) one
block's, once; C the kernel's), the scratch layout (a bijection, and the
kernel's staging stores land on it without bank conflicts), and that
`col_mask`'s words land on their entries of the S^T accumulator."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import ATTN_BF16_BWD_TOL
from r3dfsseg_tpu.ops import pallas_attention as jax_pa
from r3dfsseg_tpu_torch.ops import cuda_attention as ca

BF16 = torch.bfloat16
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
T = ca.BWD_BF16_TILE


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16).float()


def _exp2(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(x * LOG2E)


def _inputs(seed: int, b: int, n: int, d: int):
    """bf16 q, k, v (B, N, D) and an f32 cotangent dy."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32)).to(BF16)
               for _ in range(3))
    dy = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32))
    return q, k, v, dy


def _tile_offsets(b: int, kt: int, qt: int, n: int) -> torch.Tensor:
    """(64, 64) scratch entries of dS^T tile (b, key tile kt, query tile
    qt): row = key, column = query."""
    keys = torch.arange(kt * T, (kt + 1) * T)[:, None]
    queries = torch.arange(qt * T, (qt + 1) * T)[None, :]
    return ca.bwd_bf16_ds_offset(b, keys, queries, n)


def emulate_bwd(q, k, v, y, dy, lse, tau: float, rate: float = 0.0, seed: int = 0,
                c: int = ca.BWD_BF16_CLUSTER):
    """(dq, dk, dv, ds) of the kernels on bf16 q, k, v (B, N, D), D <= 64:
    f32 gradients and the flat dS scratch (bf16 values held as f32); the
    query tiles of a key tile cut over ``c`` blocks (the kernels' C by
    default, 1 for no cut)."""
    b, n, d = q.shape
    tiles = -(-n // T)
    npad, pad = tiles * T, -d % 16

    def rows(x):                          # zeros past n (the loads) and to 16 channels
        return F.pad(x, (0, pad, 0, npad - n))

    dyb = _bf16(dy)
    delta = (dyb * y).sum(-1)
    qs = _bf16(q.float() * ca.bf16_value(1.0 / tau))
    qs_p, q_p, k_p, v_p, dy_p = (rows(x) for x in (qs, q.float(), k.float(), v.float(), dyb))
    lse_p, delta_p = F.pad(lse, (0, npad - n)), F.pad(delta, (0, npad - n))
    mask = (F.pad(ca.dropout_mask_reference(b, n, rate, seed, "cpu"), (0, npad - n, 0, npad - n))
            if rate > 0.0 else torch.ones((b, npad, npad)))
    valid = torch.arange(npad) < n
    scale = 1.0 / tau
    ds = torch.zeros(ca.bwd_bf16_ds_elems(b, n))
    dk, dv = torch.zeros((b, npad, d + pad)), torch.zeros((b, npad, d + pad))
    for kt in range(tiles):
        keys = slice(kt * T, (kt + 1) * T)
        parts = []
        for r in range(c):
            gk, gv = torch.zeros((b, T, d + pad)), torch.zeros((b, T, d + pad))
            for t in range(r * tiles // c, (r + 1) * tiles // c):
                qr = slice(t * T, (t + 1) * T)
                st = k_p[:, keys] @ qs_p[:, qr].transpose(-1, -2)     # (B, keys, queries)
                dpt = v_p[:, keys] @ dy_p[:, qr].transpose(-1, -2)
                p = _exp2(st - lse_p[:, None, qr])
                p = torch.where(valid[keys, None] & valid[None, qr], p, torch.zeros(()))
                f = mask[:, qr, keys].transpose(-1, -2)
                sb = _bf16(p * (dpt * f - delta_p[:, None, qr]))
                gv = gv + _bf16(p * f) @ dy_p[:, qr]
                gk = gk + sb @ q_p[:, qr]
                for bb in range(b):
                    ds[_tile_offsets(bb, kt, t, n)] = sb[bb]
            parts.append((gk, gv))
        sum_k, sum_v = parts[0]
        for gk, gv in parts[1:]:
            sum_k, sum_v = sum_k + gk, sum_v + gv
        dk[:, keys], dv[:, keys] = sum_k * scale, sum_v
    dq = torch.zeros((b, npad, d + pad))
    for qt in range(tiles):
        acc = torch.zeros((b, T, d + pad))
        for kt in range(tiles):
            ds_t = torch.stack([ds[_tile_offsets(bb, kt, qt, n)] for bb in range(b)])
            acc = acc + ds_t.transpose(-1, -2) @ k_p[:, kt * T:(kt + 1) * T]
        dq[:, qt * T:(qt + 1) * T] = acc * scale
    return dq[:, :n, :d], dk[:, :n, :d], dv[:, :n, :d], ds


def _assert_within_gate(got, want):
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = float((a - w).abs().max())
        assert err <= ATTN_BF16_BWD_TOL * float(w.abs().max()), (name, err)


@pytest.mark.parametrize("n", [64, 256, 300])
@pytest.mark.parametrize("b", [1, 2, 10])
@pytest.mark.parametrize("d", [8, 24, 64])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_emulation_matches_plain_version(d, b, n, rate):
    """The emulated kernels against `attention_bwd_reference` with q scaled
    as the kernels scale it, from the plain forward's y and lse: each
    gradient within ATTN_BF16_BWD_TOL of its largest entry (the same bf16
    roundings at the same points; f32 sums in another order can round a dS
    or Pd entry the other way).  N = 300 cuts the last key tile and query
    tile (and leaves rank 1 of a cluster three tiles to rank 0's two); at
    N = 64 rank 0 takes none; D = 8 and 24 end in a k-step half zero."""
    q, k, v, dy = _inputs(1000 * d + 10 * b + n, b, n, d)
    tau = float(d) ** 0.5
    y, lse = ca.attention_fwd_reference(q, k, v, tau, rate, 17, kernel_scale=True)
    got = emulate_bwd(q, k, v, y, dy, lse, tau, rate, 17)[:3]
    want = ca.attention_bwd_reference(q, k, v, y, dy, lse, tau, rate, 17, kernel_scale=True)
    _assert_within_gate(got, want)


@pytest.mark.parametrize("n", [300, 512])
def test_cluster_sizes_agree(n):
    """The kernels' cut of the query tiles over a cluster of C against no
    cut (one block over all of them) on the same inputs: the dS scratch and
    dQ bit for bit (neither depends on the cut), dK and dV within f32
    rounding (the partials' sums split at another tile)."""
    q, k, v, dy = _inputs(n, 2, n, 64)
    y, lse = ca.attention_fwd_reference(q, k, v, 8.0, 0.1, 5, kernel_scale=True)
    runs = [emulate_bwd(q, k, v, y, dy, lse, 8.0, 0.1, 5, c=c)
            for c in (1, ca.BWD_BF16_CLUSTER)]
    for dq, dk, dv, ds in runs[1:]:
        assert torch.equal(ds, runs[0][3]) and torch.equal(dq, runs[0][0])
        torch.testing.assert_close(dk, runs[0][1], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(dv, runs[0][2], rtol=1e-5, atol=1e-6)


def test_scratch_holds_the_dq_products_ds():
    """The scratch holds bf16(dS) of every (query, key) < N, the values the
    TPU kernel's dQ product reads (`ds_l`): here against the plain
    version's dS, rounded alike up to a bf16 step where the f32 sums round
    it the other way; zeros past N."""
    b, n, d, tau = 2, 130, 16, 4.0
    q, k, v, dy = _inputs(3, b, n, d)
    y, lse = ca.attention_fwd_reference(q, k, v, tau, 0.1, 9, kernel_scale=True)
    ds = emulate_bwd(q, k, v, y, dy, lse, tau, 0.1, 9)[3]
    s = _bf16(q.float() * ca.bf16_value(1.0 / tau)) @ k.float().transpose(-1, -2)
    m = ca.dropout_mask_reference(b, n, 0.1, 9, "cpu")
    p = torch.exp(s - lse[..., None])
    dyb = _bf16(dy)
    want = _bf16(p * ((dyb @ v.float().transpose(-1, -2)) * m - (dyb * y).sum(-1, keepdim=True)))
    bb, qq, kk = torch.meshgrid(torch.arange(b), torch.arange(n), torch.arange(n), indexing="ij")
    got = ds[ca.bwd_bf16_ds_offset(bb, kk, qq, n)]
    assert float((got - want).abs().max()) <= 2 ** -7 * float(want.abs().max())
    inside = torch.zeros_like(ds, dtype=torch.bool)
    inside[ca.bwd_bf16_ds_offset(bb, kk, qq, n).flatten()] = True
    assert not ds[~inside].any()


@pytest.mark.parametrize("d", [16, 24, 64])
def test_emulation_matches_pallas_kernel(monkeypatch, d):
    """The emulated kernels against `_attn_bwd_kernel` in interpret mode on
    its lowp branch (bf16 q, k, v, f32 dy), rate 0 (the Pallas mask does not
    run in interpret mode), B = 2, N = 128: each gradient within
    ATTN_BF16_BWD_TOL of its largest entry (the Pallas kernel takes Delta as
    rowsum(dP * P) over its f32 P, the port as rowsum(bf16(dY) * Y))."""
    monkeypatch.setattr(jax_pa, "_INTERPRET", True)
    rng = np.random.default_rng(d + 7)
    jq, jk, jv = (jnp.asarray(rng.normal(size=(2, 128, d)).astype(np.float32)).astype(jnp.bfloat16)
                  for _ in range(3))
    dy = rng.normal(size=(2, 128, d)).astype(np.float32)
    q, k, v = (torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16) for j in (jq, jk, jv))
    tau = float(d) ** 0.5
    want = [torch.from_numpy(np.array(g))
            for g in jax_pa._bwd_impl(jq, jk, jv, 0, tau, 0.0, False, jnp.asarray(dy))]
    y, lse = ca.attention_fwd_reference(q, k, v, tau, kernel_scale=True)
    _assert_within_gate(emulate_bwd(q, k, v, y, torch.from_numpy(dy), lse, tau)[:3], want)


# --------------------------------------------------------------- plan --
@pytest.mark.parametrize("b", [1, 2, 10, 17, 40])
@pytest.mark.parametrize("n", [64, 100, 300, 2048])
def test_plan_covers_every_tile_once(b, n):
    """`bwd_bf16_plan`: the blocks of a cluster share a cloud and a key
    tile and take contiguous query-tile ranges in rank order; every
    (cloud, key tile, query tile) is one block's, once (at N = 64 rank 0
    takes none), at the training shapes' B = 10 and 2 and at batches of
    four and more blocks an SM (B = 17, 40)."""
    c = ca.BWD_BF16_CLUSTER
    blocks = ca.bwd_bf16_plan(b, n)
    tiles = -(-n // T)
    assert len(blocks) == b * tiles * c
    covered = []
    for x in range(0, len(blocks), c):
        cluster = blocks[x:x + c]
        assert len({(bb, k0) for bb, k0, _, _ in cluster}) == 1
        assert cluster[0][2] == 0 and cluster[-1][3] == tiles
        assert all(a[3] == nxt[2] for a, nxt in zip(cluster, cluster[1:]))
        covered += [(bb, k0, t) for bb, k0, lo, hi in cluster for t in range(lo, hi)]
    want = [(bb, T * kt, t) for bb in range(b) for kt in range(tiles) for t in range(tiles)]
    assert sorted(covered) == sorted(want) and len(covered) == len(set(covered))


def test_plan_takes_the_kernels_cluster_size():
    """The plan's C is the dK/dV kernel's `kCluster` in
    `csrc/attention_bwd_bf16.cu` (the kernel launches its clusters with it;
    the wrapper passes none)."""
    src = (pathlib.Path(ca.__file__).parents[1] / "csrc" / "attention_bwd_bf16.cu").read_text()
    assert re.search(r"constexpr int kCluster = (\d+);", src).group(1) == str(ca.BWD_BF16_CLUSTER)


# ------------------------------------------------------------ scratch --
@pytest.mark.parametrize("b,n", [(1, 64), (2, 130), (3, 300)])
def test_ds_layout_is_a_bijection(b, n):
    """`bwd_bf16_ds_offset` over every (cloud, key, query) of the whole
    tiles maps onto [0, `bwd_bf16_ds_elems`) one to one, each tile's 4096
    entries contiguous."""
    tiles = -(-n // T)
    bb, kk, qq = torch.meshgrid(torch.arange(b), torch.arange(tiles * T),
                                torch.arange(tiles * T), indexing="ij")
    off = ca.bwd_bf16_ds_offset(bb, kk, qq, n).flatten()
    assert off.numel() == ca.bwd_bf16_ds_elems(b, n)
    assert torch.equal(off.sort().values, torch.arange(off.numel()))
    tile = ((bb * tiles + kk // T) * tiles + qq // T).flatten()
    assert torch.equal(off // (T * T), tile)


def a_entry(warp: int, lane: int, reg: int, half: int) -> tuple[int, int]:
    """(row, column) of bf16 `half` (0 low) of register `reg` (0-3) of a
    wgmma m64k16 register A operand (`csrc/wgmma.cuh`)."""
    return 16 * (warp % 4) + lane // 4 + 8 * (reg % 2), 2 * (lane % 4) + 8 * (reg // 2) + half


def test_staging_stores_land_on_the_scratch_layout():
    """The dK/dV kernel's store of dS^T's register A operand (k-step ks,
    register i of lane (g, tq) of warp w) into its staging tile, element
    row * 64 + ((piece ^ (row % 8)) << 3) + 2 tq with row = 16 w + g + 8 (i
    % 2) and piece = 2 ks + i // 2: each (key, query) of the tile lands at
    its `bwd_bf16_ds_offset` (the staging tile is copied to the scratch as
    it lies), exactly once, and the 32 lanes of each 32-bit store reach 32
    different banks."""
    seen = set()
    for w in range(4):
        for ks in range(4):
            for i in range(4):
                banks = set()
                for lane in range(32):
                    g, tq = lane // 4, lane % 4
                    row = 16 * w + g + 8 * (i % 2)
                    piece = 2 * ks + i // 2
                    elem = row * 64 + ((piece ^ (row % 8)) << 3) + 2 * tq
                    banks.add(elem // 2 % 32)
                    for half in range(2):
                        key, col = a_entry(w, lane, i, half)
                        query = 16 * ks + col
                        assert key == row
                        assert elem + half == int(ca.bwd_bf16_ds_offset(0, key, query, 64))
                        seen.add((key, query))
                assert len(banks) == 32
    assert len(seen) == 64 * 64


@pytest.mark.parametrize("seed", [0, 2 ** 61 + 5])
def test_col_mask_words_land_on_their_entries(seed):
    """`col_mask` on the S^T accumulator of warp w (keys k0 = key0 + 16 w,
    queries i0 = q0 + 8 j): lane (g, t) draws the words of query i0 + g,
    keys k0 + 4 t .. + 3, the quad ORs its four nibbles into the 16-key
    mask of that query, and each lane takes the masks of queries 2 t and 2
    t + 1 from lanes 8 t and 8 t + 4.  With the Philox words of
    `dropout_words_reference`, every accumulator entry's factor is the
    plain mask's at its (query, key), and no lane draws a word twice."""
    b, n, rate = 2, 128, 0.3
    words = ca.dropout_words_reference(b, n, seed, "cpu")
    thr, keep = ca.dropout_threshold(rate), ca.keep_scale(rate)
    want = ca.dropout_mask_reference(b, n, rate, seed, "cpu")
    for bb in range(b):
        for key0, q0 in ((0, 0), (64, 64), (64, 0)):
            for w in range(4):
                k0 = key0 + 16 * w
                for j in range(8):
                    i0 = q0 + 8 * j
                    nib = [sum(int(int(words[bb, i0 + lane // 4, k0 + 4 * (lane % 4) + e]) >> 8
                                   >= thr) << e for e in range(4)) << (4 * (lane % 4))
                           for lane in range(32)]
                    quad = [nib[4 * (ln // 4)] | nib[4 * (ln // 4) + 1] | nib[4 * (ln // 4) + 2]
                            | nib[4 * (ln // 4) + 3] for ln in range(32)]
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        ma, mb = quad[8 * t], quad[8 * t + 4]
                        got = [ma >> g & 1, mb >> g & 1, ma >> (g + 8) & 1, mb >> (g + 8) & 1]
                        for e in range(4):
                            key = k0 + g + 8 * (e >> 1)      # accumulator register 4 j + e
                            query = i0 + 2 * t + (e & 1)
                            assert (keep if got[e] else 0.0) == float(want[bb, query, key])
