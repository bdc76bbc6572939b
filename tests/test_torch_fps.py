"""Port FPS (`ops/fps.py`, `ops/cuda_fps.py`) vs the JAX package's
`masked_fps(impl="xla")` and `multi_prototypes`.  Seeds must be EQUAL,
including masks with fewer valid points than k and invalid points
interleaved; prototypes agree within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3dfsseg_tpu.ops.fps import masked_fps as jax_fps
from r3dfsseg_tpu.ops.fps import multi_prototypes as jax_multi
from r3dfsseg_tpu_torch.ops import cuda_fps
from r3dfsseg_tpu_torch.ops.fps import masked_fps, multi_prototypes
from r3dfsseg_tpu_torch.ops.segment import segment_sum


def _instances(seed, p, n, c, keep):
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(p, n, c)).astype(np.float32)
    valid = rng.uniform(size=(p, n)) < keep
    return feat, valid


@pytest.mark.parametrize("seed,n,c,keep,k", [
    (0, 64, 8, 0.5, 10),      # invalid points interleaved
    (1, 40, 5, 0.15, 12),     # fewer valid points than k
    (2, 50, 16, 1.0, 50),     # every point becomes a seed
    (3, 30, 4, 0.0, 6),       # no valid point at all
])
def test_masked_fps_equals_jax(seed, n, c, keep, k):
    feat, valid = _instances(seed, 3, n, c, keep)
    idx, ok = masked_fps(torch.from_numpy(feat), torch.from_numpy(valid), k)
    for p in range(3):
        want_idx, want_ok = jax_fps(jnp.asarray(feat[p]), jnp.asarray(valid[p]), k, impl="xla")
        np.testing.assert_array_equal(idx[p].numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(ok[p].numpy(), np.asarray(want_ok))
    assert idx.dtype == torch.int32


@pytest.mark.parametrize("seed,keep,k", [(4, 0.6, 6), (5, 0.1, 8)])
def test_multi_prototypes_match_jax(seed, keep, k):
    feat, valid = _instances(seed, 2, 48, 6, keep)
    got = multi_prototypes(torch.from_numpy(feat), torch.from_numpy(valid), k)
    for p in range(2):
        want = jax_multi(jnp.asarray(feat[p]), jnp.asarray(valid[p]), k, impl="xla")
        np.testing.assert_allclose(got.prototypes[p].numpy(), np.asarray(want.prototypes),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got.proto_valid[p].numpy(), np.asarray(want.proto_valid))
        np.testing.assert_array_equal(got.assignments[p].numpy(), np.asarray(want.assignments))


def test_segment_sum_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(20, 3)).astype(np.float32)
    ids = rng.integers(0, 5, size=20).astype(np.int32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(ids), num_segments=5))
    np.testing.assert_allclose(segment_sum(torch.from_numpy(x), torch.from_numpy(ids), 5).numpy(),
                               want, rtol=1e-6, atol=1e-6)



# ---- csrc/fps.cu's decomposition, emulated on the CPU -------------------
def _better(v, i, bv, bi):
    return v > bv or (v == bv and i < bi)


def _fps_blocked(feat, valid, k, sms=132):
    """The kernel's decomposition in PyTorch: the instances share `sms`
    blocks (at least `POINTS_PER_BLOCK` points each), a block owns a
    contiguous range of one instance's points and offers the argmax of its
    valid points' running min (lowest index on ties), or its range's first
    index at -1 when it has no valid point; each round's pick is the
    reduction of the instance's candidates in block order.  Distances are
    the plain version's, so the seeds must be equal bit for bit."""
    p, n, _ = feat.shape
    bpi = max(1, min(sms // p, -(-n // cuda_fps.POINTS_PER_BLOCK)))
    per = -(-n // bpi)
    seeds = torch.empty((p, k), dtype=torch.int32)
    for inst in range(p):
        mind = torch.full((n,), cuda_fps.BIG, dtype=torch.float32)
        ranges = [(g * per, min(n, (g + 1) * per)) for g in range(bpi)]
        for r in range(k):
            cands = []
            for i0, i1 in ranges:
                best = (cuda_fps.NEG, i0) if i1 > i0 else (-np.inf, n)
                idx = torch.nonzero(valid[inst, i0:i1]).flatten() + i0
                if len(idx):
                    top = mind[idx].max()
                    i = int(idx[mind[idx] == top][0])
                    if _better(float(top), i, *best):
                        best = (float(top), i)
                cands.append(best)
            pick = cands[0]
            for c in cands[1:]:
                if _better(*c, *pick):
                    pick = c
            seeds[inst, r] = pick[1]
            d = ((feat[inst] - feat[inst, pick[1]]) ** 2).sum(-1)
            mind = torch.minimum(mind, d)
    return seeds


@pytest.mark.parametrize("case", ["duplicates_across_blocks", "no_valid_point",
                                  "fewer_valid_than_k", "all_valid"])
def test_fps_block_decomposition_equals_plain(case):
    rng = np.random.default_rng(11)
    feat = rng.normal(size=(3, 300, 6)).astype(np.float32)
    valid = rng.uniform(size=(3, 300)) < 0.6
    if case == "duplicates_across_blocks":
        # a far point repeated over a block boundary (5 blocks of 60 points):
        # every copy has the same running min, the lowest index must win
        feat[:, 55:66] = 40.0
        valid[:, 55:66] = True
        feat[1, 118:123] = feat[1, 7]                   # and a copy of a near one
    elif case == "no_valid_point":
        valid[1] = False
    elif case == "fewer_valid_than_k":
        valid[2] = False
        valid[2, [13, 150, 299]] = True
    else:
        valid[:] = True
    feat, valid = torch.from_numpy(feat), torch.from_numpy(valid)
    got = _fps_blocked(feat, valid, 12)
    assert torch.equal(got, cuda_fps.fps_reference(feat, valid, 12))
    if case == "duplicates_across_blocks":
        assert (got[:, 1] == 55).all()
    if case == "no_valid_point":
        assert not bool(got[1].any())


def test_fps_block_plan_at_the_flagship_calls():
    """The blocks the kernel gives each instance on 132 SMs, and the points
    each block keeps on chip (csrc/fps.cu: 119-121 KB of features)."""
    for (p, n), want in {(2, 10240): (66, 156), (1, 20480): (132, 156),
                         (10, 2048): (13, 158)}.items():
        bpi = max(1, min(132 // p, -(-n // cuda_fps.POINTS_PER_BLOCK)))
        assert (bpi, -(-n // bpi)) == want
