"""Golden parity of the port's baselines vs the original PyTorch models.

`tests/fixtures/reference_parity.npz` holds the original plain `ProtoNet`'s
outputs on episode f0 with the feature extractor of its `sd/` tensors
(`proto/{cosine,euclidean}/{eval,train}`); `reference_parity_extra.npz`
(real widths, 64 points) holds `ProtoNet_Contrast` (`pc_sd/`; eval with
MDNS, training on a noisy and on a clean episode: `pc/{eval,train,
train_clean}`) and `ProtoNet_transformer` (`pt_sd/`; `pt/{eval,train}`).
The weights go through the port's own key map (`utils/torch_convert.py`,
the learners' `load_torch_state`; the transformer's packed `in_proj`
tensors split into query, key and value), with no JAX on the way, and
every recorded output is held at the JAX package's own tolerances
(tests/test_reference_parity.py, test_reference_parity_extra.py): logits
atol = rtol = 2e-3, the CE losses 1e-4, the contrast and binary losses
5e-4, the clean-prototype loss 5e-3.  Attention dropout and the
transformer's dropout are 0, as the fixtures were recorded."""
import json
import os

import numpy as np
import pytest
import torch

from r3dfsseg_tpu_torch.config import R3DConfig
from r3dfsseg_tpu_torch.learners import ProtoLearner, TransformerLearner
from r3dfsseg_tpu_torch.models.episode import Episode

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
GATES = {"logits": 2e-3, "loss": 1e-4, "contrast_loss": 5e-4, "binary_loss": 5e-4,
         "clean_proto_loss": 5e-3}


def _load(name):
    data = np.load(os.path.join(FIXTURES, name))
    meta = json.loads(bytes(data["meta"]).decode())
    cfg = R3DConfig(
        n_way=meta["n_way"], k_shot=meta["k_shot"], n_queries=1, pc_npts=meta["pc_npts"],
        dgcnn_k=meta["dgcnn_k"], edgeconv_widths=tuple(tuple(w) for w in meta["edgeconv_widths"]),
        dgcnn_mlp_widths=tuple(meta["dgcnn_mlp_widths"]), base_widths=tuple(meta["base_widths"]),
        output_dim=meta["output_dim"], n_subprototypes=meta["n_subprototypes"],
        k_connect=meta["k_connect"], sigma=meta["sigma"], proj_dim=128, attn_dropout=0.0,
        dg_atten_dim=meta.get("dg_atten_dim", 128), knn_impl="xla", fps_impl="xla",
        compute_dtype="float32", contrast_fps_k=4)
    return data, cfg


def _sd(data, prefix):
    return {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}


def _episode(data, name):
    g = lambda f: data[f"{name}/{f}"]  # noqa: E731
    return Episode(
        support_x=torch.from_numpy(np.ascontiguousarray(g("support_x").transpose(0, 1, 3, 2))),
        support_y=torch.from_numpy(g("support_y").astype(np.int64)),
        query_x=torch.from_numpy(np.ascontiguousarray(g("query_x").transpose(0, 2, 1))),
        query_y=torch.from_numpy(g("query_y").astype(np.int64)),
        gt_support_y=torch.from_numpy(g("gt_support_y").astype(np.int64)),
        gt_query_y=torch.from_numpy(g("gt_query_y").astype(np.int64)),
        support_flag=torch.from_numpy(g("support_flag").astype(np.int64)))


def _check(out, data, key, fields):
    want = data[f"{key}/logits"].transpose(0, 2, 1)
    np.testing.assert_allclose(out.query_logits[0].numpy(), want, atol=GATES["logits"],
                               rtol=GATES["logits"])
    for field in fields:
        tol = GATES[field]
        np.testing.assert_allclose(getattr(out, field).item(), float(data[f"{key}/{field}"]),
                                   atol=tol, rtol=tol, err_msg=f"{key} {field}")


@pytest.fixture(scope="module")
def proto_golden():
    """The plain ProtoNet with the MPTI fixture's feature extractor (its
    `proj` is the MPTI model's head, which plain ProtoNet has not)."""
    data, cfg = _load("reference_parity.npz")
    sd = {k: v for k, v in _sd(data, "sd/").items() if not k.startswith("proj.")}
    ep = Episode(*(None if a is None else a[None] for a in _episode(data, "f0/ep")))
    return data, cfg, sd, ep


@pytest.mark.parametrize("dist", ["cosine", "euclidean"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_protonet_matches_reference(proto_golden, dist, mode):
    data, cfg, sd, ep = proto_golden
    learner = ProtoLearner(cfg.replace(dist_method=dist), "cpu")
    learner.load_torch_state(sd)
    with torch.no_grad():
        out = learner.model(ep, train=mode == "train")
    _check(out, data, f"proto/{dist}/{mode}", ("loss",))


@pytest.fixture(scope="module")
def extra_golden():
    data, cfg = _load("reference_parity_extra.npz")
    eps = {name: _episode(data, name).with_batch_dim() for name in ("ep", "ep_clean")}
    return data, cfg, eps


@pytest.mark.parametrize("name,key", [("ep", "eval"), ("ep", "train"),
                                      ("ep_clean", "train_clean")])
def test_protonet_contrast_matches_reference(extra_golden, name, key):
    """Eval with MDNS's clean-flag-weighted prototypes; training's CE and
    WayContrast at fps_k 4 (ep_clean takes the borrowed negatives)."""
    data, cfg, eps = extra_golden
    learner = ProtoLearner(cfg, "cpu", with_contrast=True)
    learner.load_torch_state(_sd(data, "pc_sd/"))
    with torch.no_grad():
        out = learner.model(eps[name], train=key != "eval", eval_mdns=key == "eval")
    _check(out, data, f"pc/{key}", ("loss",) if key == "eval" else ("loss", "contrast_loss"))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_transformer_matches_reference(extra_golden, mode):
    data, cfg, eps = extra_golden
    learner = TransformerLearner(cfg, "cpu", d_model=128, n_head=8, n_layers=3, d_feed=128,
                                 dropout=0.0)
    learner.load_torch_state(_sd(data, "pt_sd/"))
    with torch.no_grad():
        out = learner.model(eps["ep"], train=mode == "train")
    fields = ("loss",) if mode == "eval" else ("loss", "binary_loss", "clean_proto_loss")
    _check(out, data, f"pt/{mode}", fields)
