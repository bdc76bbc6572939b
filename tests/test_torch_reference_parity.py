"""Golden parity of the port vs the original PyTorch model.

`tests/fixtures/reference_parity.npz` (2-way 3-shot, attention: episodes
f0, f1) and `reference_parity_cfg2.npz` (3-way 2-shot, `linear_mapper`:
g0, g1) hold the original `MPTI_SelfAtten`'s weights (`sd/`), episodes and
outputs, recorded on the CPU.  These tests load the `sd/` tensors through
the port's own key map (`utils/torch_convert.py`,
`MPTILearner.load_torch_state`), replay the episodes through `MPTINet` in
the reference-faithful modes (f32, exact top-k affinity, plain kNN and FPS,
no attention dropout) and hold every recorded output at the JAX package's
own tolerances (`tests/test_reference_parity*.py`):

  * eval-mode support features: atol 2e-4, rtol 1e-3;
  * MDNS clean flags: exact;
  * query logits in eval without and with MDNS and in training: atol and
    rtol 2e-3; lp_loss 1e-4; the WayContrast loss 5e-4;
  * every parameter's gradient of lp_loss + 0.1 contrast_loss, the
    recorded torch gradients mapped through the same key map: rtol 5e-3,
    atol max(5e-3 x the leaf's scale, 1e-5 x the largest gradient).

The logits, losses and gradients are checked with the dense solve
(`lp_solver="solve"`, the fixtures' own) and with Chebyshev-150
(`lp_cg_iters=150`, `lp_adjoint_iters=0`), as the JAX tests check them.
"""
import json
import os

import numpy as np
import pytest
import torch

from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.models.mpti import mdns_keep_mask
from r3dfsseg_tpu_torch.utils.torch_convert import key_map

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
EPISODES = {"f0": "reference_parity.npz", "f1": "reference_parity.npz",
            "g0": "reference_parity_cfg2.npz", "g1": "reference_parity_cfg2.npz"}
SOLVERS = {"solve": {}, "cheby150": dict(lp_solver="cheby", lp_cg_iters=150, lp_adjoint_iters=0)}


def _config(meta) -> R3DConfig:
    """The fixture's model, as `tests/test_reference_parity.py:48-61`
    builds it, on the port's plain kNN and FPS."""
    return R3DConfig(
        n_way=meta["n_way"], k_shot=meta["k_shot"], n_queries=1,
        pc_npts=meta["pc_npts"], dgcnn_k=meta["dgcnn_k"],
        edgeconv_widths=tuple(tuple(w) for w in meta["edgeconv_widths"]),
        dgcnn_mlp_widths=tuple(meta["dgcnn_mlp_widths"]),
        base_widths=tuple(meta["base_widths"]), output_dim=meta["output_dim"],
        n_subprototypes=meta["n_subprototypes"], k_connect=meta["k_connect"],
        sigma=meta["sigma"], proj_dim=128, attn_dropout=0.0,
        use_attention=meta.get("use_attention", True),
        lp_solver="solve", affinity_impl="topk", knn_impl="xla", fps_impl="xla",
        compute_dtype="float32", contrast_fps_k=4)


@pytest.fixture(scope="module")
def golden():
    """fixture file -> (data, cfg, the `sd/` tensors); episode name ->
    its Episode of tensors (channels last, a leading episode axis)."""
    files, episodes = {}, {}
    for fname in sorted(set(EPISODES.values())):
        data = np.load(os.path.join(FIXTURES, fname))
        meta = json.loads(bytes(data["meta"]).decode())
        sd = {k[len("sd/"):]: data[k] for k in data.files if k.startswith("sd/")}
        files[fname] = (data, _config(meta), sd)
        for name in meta["fixtures"]:
            g = lambda f: data[f"{name}/ep/{f}"]  # noqa: E731
            episodes[name] = Episode(
                support_x=torch.from_numpy(np.ascontiguousarray(g("support_x").transpose(0, 1, 3, 2))),
                support_y=torch.from_numpy(g("support_y").astype(np.int64)),
                query_x=torch.from_numpy(np.ascontiguousarray(g("query_x").transpose(0, 2, 1))),
                query_y=torch.from_numpy(g("query_y").astype(np.int64)),
                gt_support_y=torch.from_numpy(g("gt_support_y").astype(np.int64)),
                gt_query_y=torch.from_numpy(g("gt_query_y").astype(np.int64)),
                support_flag=torch.from_numpy(g("support_flag").astype(np.int64)),
            ).with_batch_dim()
    return files, episodes


def _setup(golden, name, solver="solve"):
    """(data, cfg, a fresh learner holding the fixture's weights, episode)."""
    files, episodes = golden
    data, cfg, sd = files[EPISODES[name]]
    cfg = cfg.replace(**SOLVERS[solver])
    learner = MPTILearner(cfg, "cpu")
    learner.load_torch_state(sd)
    return data, cfg, learner, episodes[name]


@pytest.mark.parametrize("name", sorted(EPISODES))
def test_eval_features_match_reference(golden, name):
    data, _, learner, ep = _setup(golden, name)
    with torch.no_grad():
        sf, _ = learner.model.extract_features(ep)
    want = data[f"{name}/support_feat_eval"].transpose(0, 1, 3, 2)
    np.testing.assert_allclose(sf[0].numpy(), want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("name", sorted(EPISODES))
def test_mdns_clean_flags_match_reference(golden, name):
    data, cfg, learner, ep = _setup(golden, name)
    with torch.no_grad():
        sf, _ = learner.model.extract_features(ep)
    _, flags = mdns_keep_mask(sf[0], ep.support_y[0] > 0, ep.support_x[0, ..., :3],
                              cfg.mdns_scales)
    np.testing.assert_array_equal(flags.numpy(), data[f"{name}/eval_mdns/clean_flag"])


@pytest.mark.parametrize("solver", sorted(SOLVERS))
@pytest.mark.parametrize("mode", ["eval_plain", "eval_mdns", "train"])
@pytest.mark.parametrize("name", sorted(EPISODES))
def test_logits_and_losses_match_reference(golden, name, mode, solver):
    data, _, learner, ep = _setup(golden, name, solver)
    with torch.no_grad():
        out = learner.model(ep, train=mode == "train", eval_mdns=mode == "eval_mdns")
    want = data[f"{name}/{mode}/logits"].transpose(0, 2, 1)        # (q, N, cls)
    np.testing.assert_allclose(out.query_logits[0].numpy(), want, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(out.lp_loss.item(), float(data[f"{name}/{mode}/lp_loss"]),
                               atol=1e-4, rtol=1e-4)
    if mode == "train":
        np.testing.assert_allclose(out.contrast_loss.item(),
                                   float(data[f"{name}/train/contrast_loss"]),
                                   atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
@pytest.mark.parametrize("name", sorted(EPISODES))
def test_train_gradients_match_reference(golden, name, solver):
    """The original model's training loss, lp_loss + 0.1 contrast_loss
    (`mpti_learner.py:66` of the original code), backpropagated through
    the port; a torch parameter without a recorded gradient must get an
    exact zero, as in the JAX test."""
    data, _, learner, ep = _setup(golden, name, solver)
    out = learner.model(ep, train=True)
    (out.lp_loss + 0.1 * out.contrast_loss).backward()

    prefix = f"{name}/train_grads/"
    recorded = {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}
    assert len(recorded) >= 20, f"only {len(recorded)} reference grads in the fixture"
    to_torch = {port: key for key, (port, _) in key_map(learner.model).items()}
    params = dict(learner.model.named_parameters())
    assert set(params) <= set(to_torch)
    want = {n: recorded.get(to_torch[n], np.zeros(tuple(p.shape)))
            .reshape(tuple(p.shape)) for n, p in params.items()}
    gmax = max(float(np.abs(w).max()) for w in want.values())
    for n, p in params.items():
        got = np.zeros(tuple(p.shape)) if p.grad is None else p.grad.numpy()
        scale = max(float(np.abs(want[n]).max()), 1e-12)
        np.testing.assert_allclose(
            got, want[n], rtol=5e-3, atol=max(5e-3 * scale, 1e-5 * gmax),
            err_msg=f"gradient mismatch at {n} ({to_torch[n]}, ref grad scale {scale:.3g})")
