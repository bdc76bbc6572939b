"""Kernel 2's bf16 form at D <= 64 (`csrc/attention_fwd_bf16.cu`: wgmma
tiles, keys cut over the blocks of a thread block cluster) emulated on the
CPU, and the emulation held against the port's plain version and the JAX
package's Pallas kernel in interpret mode.  Inputs are made from seeds with
numpy.

The emulation repeats the kernel's arithmetic and its order of merges:
- q * bf16(1 / tau) rounded to bf16, q's and K's channels zero past D up
  to the next multiple of 16 (wgmma's k-depth), scores in f32;
- the launch of `fwd_bf16_plan`: rows in tiles of 64 (a block's one
  warpgroup), the keys in tiles of 64 dealt to the C blocks of a row
  tile's cluster as contiguous ranges;
- pass 1 per block: each lane t of a quad keeps its part of l over keys 8j
  + 2t + c of every tile (j = 0..7, then c = 0, 1), rescaled by exp(m -
  m_new) when the row max grows (`row_stats`), then the quad's parts summed
  as the shuffles sum them; the C blocks' (m, l) merged in rank order;
- pass 2: P = exp2((s - m) log2 e) * (1 / l), times the mask, rounded to
  bf16 before P V; each block's partial output over its keys, the C
  partials added in rank order; lse = m + log l.
exp2 is torch's and the products' f32 sums run in torch's order (the
card's ex2.approx and wgmma sum otherwise), so the emulation is held to the
card's gates: y within ATTN_BF16_FWD_TOL of the largest |y|, lse within
1e-5.  The index tests check the register layouts that the kernel relies on
(the wgmma accumulator, the register A operand P is packed into, the lanes
that draw the mask's words), and the plan test that every (cloud, row tile,
key tile) is one block's once."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_BF16_FWD_TOL
from r3dfsseg_tpu.ops import pallas_attention as jax_pa
from r3dfsseg_tpu_torch.ops import cuda_attention as ca

BF16 = torch.bfloat16
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
ROWS, KEYS = ca.FWD_BF16_BLOCK_ROWS, ca.FWD_BF16_KEYS


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16).float()


def _inputs(seed: int, b: int, n: int, d: int):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32)).to(BF16)
                 for _ in range(3))


def _exp2(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(x * LOG2E)


def _tile_scores(qs, kp, t: int, n: int) -> torch.Tensor:
    """(B, N, 64) f32 scores of key tile t, -inf past n (the ragged tile)."""
    keys = torch.arange(t * KEYS, (t + 1) * KEYS)
    kt = kp[:, keys.clamp(max=n - 1)]
    s = qs @ kt.transpose(-1, -2)
    return s.masked_fill(keys >= n, float("-inf"))


def _block_stats(qs, kp, lo: int, hi: int, n: int):
    """One block's pass 1 over key tiles [lo, hi): (m, l) per row, l summed
    per lane of the quad and then across it."""
    b = qs.shape[0]
    m = torch.full((b, n), float("-inf"))
    lanes = torch.zeros((b, n, 4))
    for t in range(lo, hi):
        s = _tile_scores(qs, kp, t, n)
        mx = torch.maximum(m, s.amax(-1))
        mb = torch.where(mx == float("-inf"), torch.zeros(()), mx)
        lanes = lanes * _exp2(m - mb)[..., None]
        m = mx
        e = _exp2(s - mb[..., None]).view(b, n, 8, 4, 2)   # key 8j + 2t + c at [j, t, c]
        for j in range(8):
            for c in range(2):
                lanes = lanes + e[:, :, j, :, c]
    l = (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3])
    return m, l


def emulate_fwd(q, k, v, tau: float, rate: float = 0.0, seed: int = 0, sms: int = 132):
    """(y, lse) of the kernel on bf16 q, k, v (B, N, D), D <= 64."""
    b, n, d = q.shape
    c, _ = ca.fwd_bf16_plan(b, n, sms)
    pad = -d % 16                       # channels zero up to wgmma's k-depth
    qs = torch.nn.functional.pad(_bf16(q.float() * ca.bf16_value(1.0 / tau)), (0, pad))
    kp = torch.nn.functional.pad(k.float(), (0, pad))
    vf = v.float()
    mask = ca.dropout_mask_reference(b, n, rate, seed, "cpu") if rate > 0.0 else None
    tiles = -(-n // KEYS)
    ranges = [(r * tiles // c, (r + 1) * tiles // c) for r in range(c)]
    stats = [_block_stats(qs, kp, lo, hi, n) for lo, hi in ranges]
    if c == 1:
        m, l = stats[0]
    else:
        m = torch.stack([s[0] for s in stats]).amax(0)
        l = torch.zeros_like(m)
        for mr, lr in stats:
            l = l + torch.where(mr == float("-inf"), torch.zeros(()), _exp2(mr - m) * lr)
    inv = 1.0 / l
    y = None
    for lo, hi in ranges:
        o = torch.zeros((b, n, d))
        for t in range(lo, hi):
            keys = torch.arange(t * KEYS, min((t + 1) * KEYS, n))
            s = _tile_scores(qs, kp, t, n)[..., :len(keys)]
            p = _exp2(s - m[..., None]) * inv[..., None]
            if mask is not None:
                p = p * mask[:, :, keys]
            o = o + _bf16(p) @ vf[:, keys]
        y = o if y is None else y + o
    return y, m + torch.log(l)


@pytest.mark.parametrize("n", [256, 300])
@pytest.mark.parametrize("b", [1, 2, 10])
@pytest.mark.parametrize("d", [8, 16, 24, 40, 64])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_emulation_matches_plain_version(d, b, n, rate):
    """The emulated kernel against `attention_fwd_reference` with q scaled
    as the kernel scales it: lse within 1e-5, y within ATTN_BF16_FWD_TOL of
    the largest |y| (exp and the sums run in another order, so an entry of
    P at a bf16 rounding boundary may round the other way).  N = 300 cuts
    the last key tile and row tile; D = 8, 24 and 40 end in a k-step half
    zero."""
    q, k, v = _inputs(1000 * d + 10 * b + n, b, n, d)
    tau = float(d) ** 0.5
    y, lse = emulate_fwd(q, k, v, tau, rate, 17)
    want_y, want_lse = ca.attention_fwd_reference(q, k, v, tau, rate, 17, kernel_scale=True)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert (y - want_y).abs().max() <= ATTN_BF16_FWD_TOL * want_y.abs().max()


@pytest.mark.parametrize("sms", [114, 132])
def test_cluster_merges_match_one_block(sms):
    """B = 1, N = 2048 takes clusters of 4 (8 key tiles a block; 32 row
    tiles start fewer than four blocks an SM at C = 2): the merged
    (m, l) and the rank-ordered sum of the partial outputs give what one
    block over all keys gives, within f32 rounding."""
    q, k, v = _inputs(9, 1, 2048, 64)
    assert ca.fwd_bf16_cluster(1, 2048, sms) == 4
    y, lse = emulate_fwd(q, k, v, 8.0, 0.1, 3, sms)
    qs = _bf16(q.float() * 0.125)
    m, l = _block_stats(qs, k.float(), 0, 32, 2048)
    torch.testing.assert_close(lse, m + torch.log(l), rtol=1e-6, atol=1e-6)
    want_y, _ = ca.attention_fwd_reference(q, k, v, 8.0, 0.1, 3, kernel_scale=True)
    assert (y - want_y).abs().max() <= ATTN_BF16_FWD_TOL * want_y.abs().max()


@pytest.mark.parametrize("d", [16, 24, 64])
def test_emulation_matches_pallas_kernel(monkeypatch, d):
    """The emulated kernel against `_attn_fwd_kernel` in interpret mode on
    its lowp branch (bf16 q, k, v), rate 0 (the Pallas mask does not run in
    interpret mode), B = 2, N = 128: y within ATTN_BF16_FWD_TOL of the
    largest |y|."""
    monkeypatch.setattr(jax_pa, "_INTERPRET", True)
    rng = np.random.default_rng(d + 5)
    jq, jk, jv = (jnp.asarray(rng.normal(size=(2, 128, d)).astype(np.float32)).astype(jnp.bfloat16)
                  for _ in range(3))
    q, k, v = (torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16) for j in (jq, jk, jv))
    tau = float(d) ** 0.5
    want = np.asarray(jax_pa._fwd_impl(jq, jk, jv, 0, tau, 0.0, False))
    y, _ = emulate_fwd(q, k, v, tau)
    assert np.abs(y.numpy() - want).max() <= ATTN_BF16_FWD_TOL * np.abs(want).max()


# ---------------------------------------------------- register layouts --
def acc_entry(warp: int, lane: int, reg: int) -> tuple[int, int]:
    """(row, column) of register `reg` of lane `lane` of warp `warp` % 4
    in a wgmma m64nN f32 accumulator (`csrc/wgmma.cuh`)."""
    return 16 * (warp % 4) + lane // 4 + 8 * (reg // 2 % 2), 8 * (reg // 4) + 2 * (lane % 4) + reg % 2


def a_entry(warp: int, lane: int, reg: int, half: int) -> tuple[int, int]:
    """(row, column) of bf16 `half` (0 low) of register `reg` (0-3) of a
    wgmma m64k16 register A operand."""
    return 16 * (warp % 4) + lane // 4 + 8 * (reg % 2), 2 * (lane % 4) + 8 * (reg // 2) + half


@pytest.mark.parametrize("ncols", [16, 64])
def test_accumulator_layout_is_a_bijection(ncols):
    """The 4 warps x 32 lanes x ncols / 2 registers of an m64nN accumulator
    hold each (row, column) of the 64 x N tile exactly once."""
    seen = [acc_entry(w, ln, r) for w in range(4) for ln in range(32) for r in range(ncols // 2)]
    assert len(seen) == len(set(seen)) == 64 * ncols
    assert {rc[0] for rc in seen} == set(range(64)) and {rc[1] for rc in seen} == set(range(ncols))


def test_scores_pack_into_the_register_a_operand():
    """`acc_frag_bf16`'s packing of S's tiles 2s and 2s + 1 into k-step s
    of P's register A operand (register i from accumulator entries 4 (2s +
    i // 2) + 2 (i % 2) and + 1, low half first): every (row, key) of the 64
    x 64 tile reaches the A slot of the same row and of key 16 s + its
    column in the step, from the same lane, exactly once."""
    slots = set()
    for w in range(4):
        for ln in range(32):
            for s in range(4):
                for i in range(4):
                    for half in range(2):
                        reg = 4 * (2 * s + i // 2) + 2 * (i % 2) + half
                        row, key = acc_entry(w, ln, reg)
                        a_row, a_col = a_entry(w, ln, i, half)
                        assert (row, key) == (a_row, 16 * s + a_col)
                        slots.add((row, key))
    assert len(slots) == 64 * 64


def test_mask_words_land_on_their_entries():
    """`row_mask` on the accumulator: lane (g, t) of a warp with `odd` = t %
    2 draws the four words of row g + 8 odd at key group (8j + 2t) / 4 and
    swaps halves with lane t ^ 1; each of its registers 4j .. 4j + 3 gets
    the word of its own (row, key), and no (row, key group) is drawn twice
    (a warp's 16 rows x 16 groups of a 64-key tile, each once)."""
    def word(row, key):
        return ("w", row, key)

    drawn = []
    for ln in range(32):
        g, t = ln // 4, ln % 4
        for j in range(8):
            col = 8 * j + 2 * t
            own = [word(g + 8 * (t % 2), 4 * (col // 4) + e) for e in range(4)]
            drawn.append((g + 8 * (t % 2), col // 4))
            pt = t ^ 1
            pcol = 8 * j + 2 * pt
            partner = [word(g + 8 * (pt % 2), 4 * (pcol // 4) + e) for e in range(4)]
            # what the partner sends: odd ? (w.x, w.y) : (w.z, w.w)
            got = partner[:2] if pt % 2 else partner[2:]
            if t % 2:
                regs = [got[0], got[1], own[2], own[3]]
            else:
                regs = [own[0], own[1], got[0], got[1]]
            for e in range(4):
                row, key = acc_entry(0, ln, 4 * j + e)
                assert regs[e] == word(row, key)
    assert len(drawn) == len(set(drawn)) == 16 * 16


# --------------------------------------------------------------- plan --
@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("b", [1, 2, 10, 12])
@pytest.mark.parametrize("n", [300, 2048, 4096])
def test_plan_covers_every_tile_once(sms, b, n):
    """`fwd_bf16_plan`: C is 1, 2 or 4 and divides the grid; the blocks of
    a cluster share a cloud and a row tile and take contiguous key ranges
    in rank order; every (cloud, row tile, key tile) is one block's,
    once."""
    c, blocks = ca.fwd_bf16_plan(b, n, sms)
    assert c in (1, 2, 4) and len(blocks) % c == 0
    tiles, row_tiles = -(-n // KEYS), -(-n // ROWS)
    assert len(blocks) == b * row_tiles * c
    covered = []
    for x in range(0, len(blocks), c):
        cluster = blocks[x:x + c]
        assert len({(bb, r0) for bb, r0, _, _ in cluster}) == 1
        assert cluster[0][2] == 0 and cluster[-1][3] == tiles
        assert all(a[3] == nxt[2] for a, nxt in zip(cluster, cluster[1:]))
        covered += [(bb, r0, t) for bb, r0, lo, hi in cluster for t in range(lo, hi)]
    want = [(bb, ROWS * r, t) for bb in range(b) for r in range(row_tiles) for t in range(tiles)]
    assert sorted(covered) == sorted(want) and len(covered) == len(set(covered))


def test_training_shapes_take_the_cluster_route():
    """B = 10 and 2 at N = 2048 on 132 SMs: C = 2 (640 blocks, four an SM
    or more) and C = 4 (256 blocks, fewer than four at any C)."""
    assert [ca.fwd_bf16_plan(b, 2048)[0] for b in (10, 2)] == [2, 4]
    assert [len(ca.fwd_bf16_plan(b, 2048)[1]) for b in (10, 2)] == [640, 256]


@pytest.mark.parametrize("b,c", [(17, 1), (10, 2), (9, 2), (8, 4), (2, 4), (1, 4)])
def test_cluster_size_by_batch(b, c):
    """The C that the wrapper passes at N = 2048 on 132 SMs: B = 17 is the
    smallest batch with four blocks an SM at C = 1 (544 row tiles), B = 9
    at C = 2; below that C = 4.  The card test reaches each C by these
    shapes."""
    assert ca.fwd_bf16_cluster(b, 2048, 132) == c
