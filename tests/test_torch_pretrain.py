"""Encoder pretraining in the port (`nn/dgcnn.py:DGCNNSegAttention`,
`nn/nonlocal_block.py`, `pretrain.py`, `utils/checkpoint.py`'s pretraining
checkpoints) against the JAX package, on the CPU at narrow widths:

  * the segmentation model, v1 and v2, on the same Flax weights: eval and
    train-mode logits and the few-shot features within rtol = atol = 1e-4,
    the BatchNorm running statistics after a train pass within 1e-5; the
    inputs first show a kNN margin above 1e-6 in every EdgeConv block
    (`knn_margin`: the JAX package's `jax_graph_margin` measure on the
    blocks' kNN graphs, where a rounding-level tie would let the two
    frameworks keep different neighbours);
  * one pretraining step (`pretrain_step`, Adam at 1e-3) against the JAX
    pretraining step: loss and accuracy rtol 1e-4, each gradient within a
    relative L2 distance of 1e-3, the updated parameters within 1e-5;
  * the original model's recorded `DGCNNSeg_attention(_v2)` outputs
    (`tests/fixtures/reference_parity_extra.npz`, seg_v1 and seg_v2, eval
    and train) through the port's key map (`seg_key_map`) at the JAX
    test's atol = rtol = 3e-3;
  * `NonLocalBlock` in its four modes within 1e-5, and the identity at
    init, exactly;
  * `pretrain()` on a synthetic dataset: the batch stream equal to the JAX
    run's (sha256 of the first batches, the model-init draw included),
    pretrain -> finetune -> meta-train through the CLIs, the JAX
    `load_pretrain_checkpoint` on the port's `.tar`, the attention head
    dropped on an encoder-only load, and the CLI in a fresh interpreter
    without msgpack, flax, h5py or tensorboard.

TensorBoard is blocked here (`torch.utils.tensorboard` imports TensorFlow,
which takes many seconds); the scalars go to `scalars.jsonl`."""
import hashlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import watch_encoder_install
from r3dfsseg_tpu.nn import DGCNNSegAttention as JaxSeg
from r3dfsseg_tpu.nn.dgcnn import DGCNN as JaxDGCNN
from r3dfsseg_tpu.nn.nonlocal_block import NonLocalBlock as JaxNonLocal
from r3dfsseg_tpu_torch import mpti_train_noise, pretrain as port_pretrain
from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.data.synthetic import make_synthetic_dataset
from r3dfsseg_tpu_torch.eval_noise import make_learner
from r3dfsseg_tpu_torch.nn.dgcnn import DGCNNSegAttention
from r3dfsseg_tpu_torch.nn.nonlocal_block import MODES, NonLocalBlock
from r3dfsseg_tpu_torch.utils import checkpoint, torch_convert
from r3dfsseg_tpu_torch.utils.convert import jax_tree_from_state_dict, state_dict_from_jax
from torch_port_helpers import random_flax_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "reference_parity_extra.npz")
WIDTHS = ((8, 8), (8, 8), (8, 8))
MLP = (16, 12)
K, ATT, CLASSES = 4, 8, 5
TINY = dict(dataset="s3dis", cvfold=0, pc_npts=64, dgcnn_k=K, edgeconv_widths=WIDTHS,
            dgcnn_mlp_widths=MLP, base_widths=(8, 8), output_dim=8, dg_atten_dim=ATT,
            use_attention=True, n_subprototypes=8, k_connect=8, lp_cg_iters=20, n_way=2,
            k_shot=2, n_queries=1, n_episode_test=1, n_workers=1)
TINY_FLAGS = ["--pc_npts", "64", "--dgcnn_k", str(K), "--edgeconv_widths", "[[8,8],[8,8],[8,8]]",
              "--dgcnn_mlp_widths", "[16,12]", "--base_widths", "[8,8]", "--output_dim", "8",
              "--dg_atten_dim", str(ATT), "--use_attention", "--n_subprototypes", "8",
              "--k_connect", "8", "--lp_cg_iters", "20", "--n_way", "2", "--k_shot", "2",
              "--n_episode_test", "1", "--n_workers", "1"]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("torch_pretrain") / "blocks"),
                                  n_scans=40, pts_per_scan=512, seed=3)


def _cfg(ds, tmp, **kw) -> R3DConfig:
    return R3DConfig(clean_data_path=ds, log_dir=str(tmp / "run"), save_path=str(tmp),
                     **{**TINY, **kw})


def knn_margin(feats: np.ndarray, k: int) -> float:
    """Smallest gap, over the points of every cloud, between the k-th and
    the (k+1)-th nearest distance (self included, as the kNN counts it),
    relative to the squared norms that the Gram form cancels (float64)."""
    f = feats.astype(np.float64)
    out = np.inf
    for c in f:
        d = ((c[:, None] - c[None]) ** 2).sum(-1)
        s = np.sort(d, axis=1)
        nrm = (c * c).sum(1)
        out = min(out, float(((s[:, k] - s[:, k - 1]) / (nrm + np.median(nrm))).min()))
    return out


# ------------------------------------------------------------ the model --
@pytest.fixture(scope="module")
def seg_pair():
    """v2 -> (JAX model, its random Flax (params, batch_stats), the port
    model holding them), at narrow widths without dropout.  The running
    statistics are a train pass's batch statistics on clouds like the
    tests' (random ones collapse the eval-mode features of the later
    blocks onto near-duplicate points, where no kNN margin holds)."""
    out = {}
    for v2 in (False, True):
        jm = JaxSeg(num_classes=CLASSES, edgeconv_widths=WIDTHS, dgcnn_mlp_widths=MLP,
                    dgcnn_k=K, atten_dim=ATT, dropout=0.0, attn_dropout=0.0, v2=v2)
        variables = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((2, 64, 9)), train=False))
        rng = np.random.default_rng(11 + v2)
        params, stats = random_flax_weights(variables, rng)
        x = jnp.asarray(rng.normal(size=(3, 64, 9)).astype(np.float32))
        _, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"],
                                               rngs={"dropout": jax.random.PRNGKey(0)}))(
            {"params": params, "batch_stats": stats}, x)
        # running = 0.9 running + 0.1 batch (the JAX package's BatchNorm momentum)
        stats = jax.tree.map(lambda new, old: ((np.asarray(new) - 0.9 * old) / 0.1)
                             .astype(np.float32), mut["batch_stats"], stats)
        tm = DGCNNSegAttention(9, CLASSES, WIDTHS, MLP, K, atten_dim=ATT, dropout=0.0,
                               attn_dropout=0.0, v2=v2)
        tm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
        out[v2] = (jm, params, stats, tm)
    return out


def _block_inputs(params, stats, x, train: bool):
    """The JAX trunk's EdgeConv inputs on ``x``: x and the first blocks'
    outputs."""
    trunk = JaxDGCNN(WIDTHS, MLP, k=K, return_edgeconvs=True)
    v = {"params": params["encoder"], "batch_stats": stats["encoder"]}
    outs, _ = jax.jit(lambda v, x: trunk.apply(v, x, train=train, mutable=["batch_stats"])[0])(
        v, x)
    return [np.asarray(x)] + [np.asarray(o) for o in outs[:-1]]


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_seg_model_matches_jax(seg_pair, v2):
    jm, params, stats, tm = seg_pair[v2]
    rng = np.random.default_rng(21 + v2)
    x = rng.normal(size=(3, 64, 9)).astype(np.float32)
    for train in (False, True):
        margin = min(knn_margin(f, K) for f in _block_inputs(params, stats, jnp.asarray(x),
                                                             train))
        assert margin > 1e-6, f"a kNN tie at f32 rounding ({margin:.1e}), train={train}"
    variables = {"params": params, "batch_stats": stats}
    want, want_feat = jax.jit(lambda v, x: jm.apply(v, x, return_feat=True))(variables,
                                                                            jnp.asarray(x))
    with torch.no_grad():
        got, got_feat = tm(torch.from_numpy(x), return_feat=True)
    assert got.shape == (3, 64, CLASSES) and got_feat.shape == (3, 64, 8 + ATT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_feat.numpy(), np.asarray(want_feat), rtol=1e-4, atol=1e-4)

    (want, want_feat), mut = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, return_feat=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(variables, jnp.asarray(x))
    port = DGCNNSegAttention(9, CLASSES, WIDTHS, MLP, K, atten_dim=ATT, dropout=0.0,
                             attn_dropout=0.0, v2=v2)
    port.load_state_dict(tm.state_dict())
    with torch.no_grad():
        got, got_feat = port(torch.from_numpy(x), train=True, return_feat=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_feat.numpy(), np.asarray(want_feat), rtol=1e-4, atol=1e-4)
    want_s = state_dict_from_jax({}, jax.tree.map(np.asarray, mut["batch_stats"]))
    got_s = port.state_dict()
    assert want_s
    for name, w in want_s.items():
        np.testing.assert_allclose(got_s[name].numpy(), w.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_pretraining_step_matches_jax(seg_pair):
    """`pretrain_step` against the JAX pretraining step (`pretrain.py`'s
    loss_fn and optax.adam) from the same weights on the same batch.  The
    updated parameters: all of them within 1e-5 of optax's Adam step on the
    port's own gradients, and within 1e-5 of the JAX step's where the JAX
    gradient is at least 1e-3 of its parameter's largest entry (Adam's
    first step, lr g / (|g| + eps), turns the rounding of a gradient near
    eps into a step of up to lr).  The segmenter's second conv bias feeds
    a train-mode BatchNorm: its exact gradient is 0 and both sides hold
    rounding noise, which must stay far below the largest gradient."""
    jm, params, stats, tm = seg_pair[False]
    rng = np.random.default_rng(32)
    x = rng.normal(size=(4, 64, 9)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=(4, 64)).astype(np.int32)
    assert min(knn_margin(f, K) for f in _block_inputs(params, stats, jnp.asarray(x),
                                                        True)) > 1e-6
    tx = optax.adam(1e-3)

    def loss_fn(p):
        logits, mut = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                               mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        logp = jax.nn.log_softmax(logits, axis=-1)
        ce = -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[..., None], -1))
        acc = jnp.mean((jnp.argmax(logits, -1) == jnp.asarray(y)).astype(jnp.float32))
        return ce, (mut["batch_stats"], acc)

    @jax.jit
    def adam_tree(grads):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    def adam_step(grads):
        return state_dict_from_jax(jax.tree.map(np.asarray, adam_tree(grads)))

    (loss, (_, acc)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want_p = adam_step(grads)

    model = DGCNNSegAttention(9, CLASSES, WIDTHS, MLP, K, atten_dim=ATT, dropout=0.0,
                              attn_dropout=0.0)
    model.load_state_dict(tm.state_dict())
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    got_loss, got_acc = port_pretrain.pretrain_step(model, opt, torch.from_numpy(x),
                                                    torch.from_numpy(y), torch.Generator())
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-4)
    np.testing.assert_allclose(got_acc.item(), float(acc), rtol=1e-4)
    want_g = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    own_g = jax_tree_from_state_dict(model)[0]
    for name, p in model.named_parameters():     # the tree of the port's gradients
        node = own_g
        *path, leaf = name.split(".")
        for part in path:
            node = node[part]
        g = p.grad.numpy()
        node["kernel" if p.dim() == 2 else "bias" if leaf == "bias" else "scale"] = \
            np.ascontiguousarray(g.T if p.dim() == 2 else g)
    own_p = adam_step(own_g)
    top = max(float(np.abs(g.numpy()).max()) for g in want_g.values())
    zero = {"seg1.conv.bias"}
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want_g[name].numpy()
        got = p.detach().numpy()
        np.testing.assert_allclose(got, own_p[name].numpy(), rtol=0, atol=1e-5, err_msg=name)
        if name in zero:
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-5 * top, name
            continue
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-3, (name, rel)
        sure = np.abs(w) >= 1e-3 * np.abs(w).max()
        np.testing.assert_allclose(got[sure], want_p[name].numpy()[sure], rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("tag,v2", [("seg_v1", False), ("seg_v2", True)])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_seg_golden_fixtures(tag, v2, mode):
    """The original `DGCNNSeg_attention(_v2)`'s recorded weights through the
    port's key map, strictly, and its recorded logits
    (`tests/test_reference_parity_extra.py:182-231`)."""
    data = np.load(FIXTURE)
    meta = json.loads(bytes(data["meta"]).decode())
    model = DGCNNSegAttention(
        9, meta["num_classes"], tuple(tuple(w) for w in meta["edgeconv_widths"]),
        tuple(meta["dgcnn_mlp_widths"]), meta["dgcnn_k"], atten_dim=meta["dg_atten_dim"],
        dropout=0.0, attn_dropout=0.0, v2=v2)
    sd = {k[len(f"{tag}_sd/"):]: data[k] for k in data.files if k.startswith(f"{tag}_sd/")}
    kmap = torch_convert.seg_key_map(model)
    assert {k for k in sd if not k.endswith("num_batches_tracked")} == set(kmap)
    model.load_state_dict(torch_convert.state_dict_from_torch(sd, model, kmap), strict=True)
    x = torch.from_numpy(data["seg/x"].transpose(0, 2, 1).copy())
    with torch.no_grad():
        got = model(x, train=mode == "train", generator=torch.Generator())
    want = data[f"{tag}/{mode}/logits"].transpose(0, 2, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-3, rtol=3e-3)


def test_seg_export_round_trips():
    """`export_seg_encoder` writes the original encoder's keys, attention
    maps included, and the key map takes them back bit for bit."""
    g = torch.Generator().manual_seed(4)
    model = DGCNNSegAttention(9, CLASSES, WIDTHS, MLP, K, atten_dim=ATT)
    port_pretrain.init_linear_weights(model, g)
    enc = torch_convert.export_seg_encoder(model)
    assert {"att_learner.q_map.weight", "edge_convs.0.layer.0.weight",
            "conv.layer.4.running_var"} <= set(enc)
    assert enc["edge_convs.0.layer.0.weight"].shape == (8, 18, 1, 1)
    other = DGCNNSegAttention(9, CLASSES, WIDTHS, MLP, K, atten_dim=ATT)
    sd = torch_convert.state_dict_from_torch({"encoder." + k: v for k, v in enc.items()},
                                             other, torch_convert.seg_key_map(other))
    want = model.state_dict()
    assert set(sd) == {k for k in want if k.startswith(("encoder.", "att_learner."))}
    for k, v in sd.items():
        assert torch.equal(v, want[k]), k


# --------------------------------------------------------- non-local block --
@pytest.mark.parametrize("mode", MODES)
def test_nonlocal_block_matches_jax(mode):
    rng = np.random.default_rng(MODES.index(mode))
    x = rng.normal(size=(2, 16, 6)).astype(np.float32)
    jm = JaxNonLocal(in_channels=6, inter_channels=4, mode=mode)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params, stats = random_flax_weights(variables, rng, wscale=1.0)
    tm = NonLocalBlock(6, 4, mode)
    tm.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    v = {"params": params, "batch_stats": stats}
    for train in (False, True):
        if train:
            (z, f), _ = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        else:
            z, f = jm.apply(v, jnp.asarray(x))
        with torch.no_grad():
            gz, gf = tm(torch.from_numpy(x), train)
        np.testing.assert_allclose(gz.numpy(), np.asarray(z), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gf.numpy(), np.asarray(f), rtol=1e-5, atol=1e-5)
    x = torch.from_numpy(x)
    for bn in (True, False):
        block = NonLocalBlock(6, 4, mode, bn_layer=bn)
        with torch.no_grad():
            for train in (False, True):
                assert torch.equal(block(x, train)[0], x), (bn, train)


# ------------------------------------------------------------ pretraining --
def test_batch_stream_matches_jax(ds, tmp_path, monkeypatch):
    """The JAX `pretrain()` on the same dataset and seed, its sampler
    recorded and stopped once it starts the second training batch: its
    model-init draw and first batch equal the port's stream's first two
    (sha256 over x and y), with augmentation on."""
    import r3dfsseg_tpu.data.sampler as jax_sampler
    from pretrain import pretrain as jax_pretrain
    from r3dfsseg_tpu.config import R3DConfig as JaxConfig

    bs = 3
    calls = []
    real = jax_sampler.sample_scan

    class Enough(Exception):
        pass

    def recording(*a, **kw):
        if len(calls) == 2 * bs:
            raise Enough
        out = real(*a, **kw)
        calls.append(out[:2])
        return out

    monkeypatch.setattr(jax_sampler, "sample_scan", recording)
    kw = dict(TINY, pc_augm=True, pc_augm_scale=0.1, pc_augm_mirror_prob=0.5, seed=5)
    jcfg = JaxConfig(clean_data_path=ds, log_dir=str(tmp_path / "jax"), mesh_shape=(1,),
                     **{k: v for k, v in kw.items() if k != "n_workers"})
    with pytest.raises(Enough):
        jax_pretrain(jcfg, batch_size=bs)
    want = [(np.stack([c[0] for c in calls[i:i + bs]]),
             np.stack([c[1] for c in calls[i:i + bs]]).astype(np.int32))
            for i in (0, bs)]

    cfg = _cfg(ds, tmp_path, **kw)
    stream = port_pretrain.batch_stream(cfg, bs, *port_pretrain.pretrain_scans(cfg))
    got = [next(stream) for _ in range(2)]

    def digest(batches):
        h = hashlib.sha256()
        for x, y in batches:
            h.update(np.ascontiguousarray(x).tobytes())
            h.update(np.ascontiguousarray(y).tobytes())
        return h.hexdigest()

    assert digest(got) == digest(want)
    assert got[0][0].shape == (bs, 64, 9) and got[0][1].dtype == np.int32
    assert got[0][1].max() > 0


def test_pretrain_finetune_metatrain(ds, tmp_path):
    """--phase pretrain, then finetune from its checkpoint, then meta-training
    with --pretrain_checkpoint_path (the JAX package's
    tests/test_cli_phases.py:86-134): the finetune log says it loaded the
    encoder, the meta-training learner's trunk equals the artifact's
    tensors at init, and two steps move it."""
    base = ["--clean_data_path", ds, "--device", "cpu", "--save_path", str(tmp_path)] + TINY_FLAGS
    out = port_pretrain.main(base + ["--n_iters", "10", "--pretrain_batch_size", "4",
                                     "--log_dir", "pre"])
    assert out.endswith("pretrain_checkpoint.tar") and os.path.exists(out)
    log = open(os.path.join(os.path.dirname(out), "log_pretrain.txt")).read()
    losses = [float(v) for v in __import__("re").findall(r"\[Pretrain\] Iter 10 \| loss ([0-9.]+)",
                                                          log)]
    assert len(losses) == 1 and np.isfinite(losses[0])
    blob = torch.load(out, weights_only=True)
    assert set(blob) == {"params"} and "att_learner.q_map.weight" in blob["params"]

    mpti_train_noise.main(base + ["--phase", "finetune", "--n_iters", "2",
                                  "--pretrain_checkpoint_path", out, "--log_dir", "ft"])
    ft_dir = os.path.join(os.path.dirname(os.path.dirname(out)), "ft")
    assert "finetune: loaded encoder" in open(os.path.join(ft_dir, "log_finetune.txt")).read()
    assert os.path.exists(os.path.join(ft_dir, "pretrain_checkpoint.tar"))

    seen = watch_encoder_install(mpti_train_noise, torch_convert)
    try:
        mpti_train_noise.main(base + ["--phase", "mptitrain", "--n_iters", "2",
                                      "--eval_interval", "2", "--pretrain_checkpoint_path", out,
                                      "--log_dir", "mt"])
    finally:
        seen.pop("restore")()
    mt_dir = os.path.join(os.path.dirname(ft_dir), "mt")
    log = open(os.path.join(mt_dir, "log_mptitrain.txt")).read()
    assert "Load encoder module" in log and "attention head" in log

    trunk = {k: v for k, v in blob["params"].items()
             if not k.startswith("att_learner.") and not k.endswith("num_batches_tracked")}
    init = seen["init"]
    end = torch_convert.export_feature_extractor(seen["learner"].model.features)
    trained = torch.load(os.path.join(mt_dir, "checkpoint_2.tar"),
                         weights_only=False)["model_state_dict"]
    moved = 0.0
    for k, v in trunk.items():
        assert torch.equal(init["encoder." + k], v), k
        assert torch.equal(end["encoder." + k], trained["encoder." + k]), k
        moved = max(moved, float((trained["encoder." + k] - v).abs().max()))
    assert moved > 0, "the encoder did not train"


def test_jax_reads_the_port_pretraining_checkpoint(tmp_path):
    """The JAX `load_pretrain_checkpoint` reads the port's `.tar` into a
    trunk bit-equal to the port model's; the port's `.msgpack` is the JAX
    pretraining artifact's layout, and both read back into the port."""
    from r3dfsseg_tpu.config import tiny_config as jax_tiny_config
    from r3dfsseg_tpu.utils.checkpoint import load_pretrain_checkpoint as jax_load

    model = DGCNNSegAttention(9, CLASSES, WIDTHS, MLP, K, atten_dim=ATT)
    port_pretrain.init_linear_weights(model, torch.Generator().manual_seed(8))
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.normal_(generator=torch.Generator().manual_seed(len(name)))
    want_p, want_s = jax_tree_from_state_dict(model.encoder)
    jcfg = jax_tiny_config(edgeconv_widths=WIDTHS, dgcnn_mlp_widths=MLP)
    for name in ("pre.tar", "pre.msgpack"):
        path = str(tmp_path / name)
        checkpoint.save_pretrain_checkpoint(path, model)
        p, s = jax_load(path, jcfg)
        assert set(p["features"]) == {"encoder"}
        for tree, want in ((p["features"]["encoder"], want_p), (s["features"]["encoder"], want_s)):
            flat = jax.tree_util.tree_flatten_with_path(tree)[0]
            assert len(flat) == len(jax.tree.leaves(want))
            for kp, leaf in flat:
                w = want
                for e in kp:
                    w = w[e.key]
                np.testing.assert_array_equal(np.asarray(leaf), w, err_msg=str(kp))
        sd = checkpoint.load_pretrain_checkpoint(path, model.encoder)
        ref = model.encoder.state_dict()
        assert set(sd) == set(ref) and all(torch.equal(sd[k], ref[k]) for k in sd)


def test_encoder_only_loads_drop_the_attention_head(tmp_path):
    """An encoder-only load drops the pretraining model's attention head
    (`encoder.att_learner.*`) and says so; a stray key still raises."""
    model = DGCNNSegAttention(9, CLASSES, WIDTHS, MLP, K, atten_dim=ATT)
    path = str(tmp_path / "pre.tar")
    checkpoint.save_pretrain_checkpoint(path, model)
    said = []
    sd = checkpoint.load_pretrain_checkpoint(path, model.encoder, log=said.append)
    assert set(sd) == set(model.encoder.state_dict())
    assert len(said) == 1 and "encoder.att_learner.q_map.weight" in said[0]

    learner = make_learner(R3DConfig(**TINY), "cpu")
    said = []
    checkpoint.restore(path, learner, log=said.append)
    assert len(said) == 1 and all(f"encoder.att_learner.{m}.weight" in said[0]
                                  for m in ("k_map", "q_map", "v_map"))
    got = learner.model.features.encoder.state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items())

    blob = torch.load(path, weights_only=True)
    blob["params"]["stray.weight"] = torch.zeros(3)
    torch.save(blob, path)
    with pytest.raises(KeyError, match="stray.weight"):
        checkpoint.load_pretrain_checkpoint(path, model.encoder)
    with pytest.raises(KeyError, match="stray.weight"):
        checkpoint.restore(path, learner)


def test_pretrain_defaults_to_cuda(ds, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_pretrain.pretrain(_cfg(ds, tmp_path, n_iters=1), batch_size=2)


def test_pretrain_cli_without_jax_msgpack_h5py(tmp_path):
    """The pretraining CLI through `python -m`'s entry in a fresh
    interpreter where msgpack, flax, h5py and tensorboard cannot be
    imported (as on the card's machine); jax and the JAX package absent at
    the end."""
    code = f"""
import runpy, sys
for m in ("h5py", "msgpack", "flax", "torch.utils.tensorboard"):
    sys.modules[m] = None
from r3dfsseg_tpu_torch.data.synthetic import make_synthetic_dataset
ds = make_synthetic_dataset({str(tmp_path / 'blocks')!r}, n_scans=40, pts_per_scan=512, seed=7)
sys.argv = ["pretrain", "--n_iters", "2", "--pretrain_batch_size", "2", "--save_path",
            {str(tmp_path)!r}, "--log_dir", "run", "--clean_data_path", ds,
            "--device", "cpu"] + {TINY_FLAGS!r}
runpy.run_module("r3dfsseg_tpu_torch.pretrain", run_name="__main__")
bad = sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m == "jax" or m.startswith(("jax.", "r3dfsseg_tpu.", "flax")) or m == "r3dfsseg_tpu"))
assert not bad, bad
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "saved encoder checkpoint" in proc.stdout
    assert os.path.exists(tmp_path / "Cleantrain" / "S0_N2_K2_Att1" / "run" /
                          "pretrain_checkpoint.tar")
