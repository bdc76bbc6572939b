"""The port's R3DConfig is the JAX package's, field by field."""
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

import r3dfsseg_tpu.config as jax_config
import r3dfsseg_tpu_torch.config as torch_config

REPO = str(pathlib.Path(__file__).resolve().parent.parent)


def _fields(cls):
    return {f.name: f for f in dataclasses.fields(cls)}


def test_config_fields_have_the_same_names_and_defaults():
    jf, tf = _fields(jax_config.R3DConfig), _fields(torch_config.R3DConfig)
    assert list(tf) == list(jf)
    jdef, tdef = jax_config.R3DConfig(), torch_config.R3DConfig()
    for name in jf:
        assert getattr(tdef, name) == getattr(jdef, name), name


@pytest.mark.parametrize("prop", ["pc_in_dim", "n_classes", "feat_dim", "num_proto_slots",
                                  "num_query_points", "num_nodes"])
def test_config_derived_sizes_agree(prop):
    for j, t in ((jax_config.R3DConfig(), torch_config.R3DConfig()),
                 (jax_config.tiny_config(), torch_config.tiny_config())):
        assert getattr(t, prop) == getattr(j, prop)
    assert torch_config.R3DConfig().num_nodes == 4396


def test_tiny_config_matches():
    assert dataclasses.asdict(torch_config.tiny_config(k_shot=3)) == \
        dataclasses.asdict(jax_config.tiny_config(k_shot=3))


@pytest.mark.parametrize("mode", ["on", "auto", "off"])
def test_fuse_edge_on_is_refused_by_both_packages(mode):
    """The JAX package's EdgeConv raises on fuse_edge='on' (the fused tail
    is archived there); the port's model refuses the config the same way,
    and both run 'auto' and 'off'."""
    from r3dfsseg_tpu.nn.dgcnn import EdgeConv as JaxEdgeConv
    from r3dfsseg_tpu_torch.models.mpti import MPTINet

    block = JaxEdgeConv(widths=(8, 8), k=4, knn_impl="xla", fuse_edge=mode)
    cfg = torch_config.tiny_config(fuse_edge=mode)
    if mode == "on":
        with pytest.raises(NotImplementedError):
            block.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 3)))
        with pytest.raises(NotImplementedError, match="fuse_edge"):
            MPTINet(cfg)
    else:
        block.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 3)))
        MPTINet(cfg)


def test_port_imports_no_jax():
    """Importing the port, its serving path, its training step, its data
    pipeline, its CLIs, its pretraining, its Flax checkpoints, the
    baselines (models, learners, ccns; both served) and whole-scene
    serving (`predict_scene` on the dense, blocked and sparse graphs) pulls in
    neither jax nor the JAX package, nor flax, h5py or msgpack (a fresh
    interpreter, so this process's jax does not count)."""
    code = (
        "import os, sys\n"
        "import r3dfsseg_tpu_torch, chip_smoke\n"
        "import r3dfsseg_tpu_torch.data, r3dfsseg_tpu_torch.native, r3dfsseg_tpu_torch.cli\n"
        "from r3dfsseg_tpu_torch import mpti_train_noise, eval_noise, pretrain\n"
        "from r3dfsseg_tpu_torch.utils import checkpoint, flax_msgpack\n"
        "from r3dfsseg_tpu_torch.nn import nonlocal_block\n"
        "from r3dfsseg_tpu_torch.data import cache, catalogs, episodes, loader, sampler, synthetic\n"
        "from r3dfsseg_tpu_torch.utils import metrics, logger, diagnostics\n"
        "from r3dfsseg_tpu_torch.serve import FewShotPredictor\n"
        "from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner\n"
        "from r3dfsseg_tpu_torch.learners import ProtoLearner, TransformerLearner, make_learner\n"
        "from r3dfsseg_tpu_torch.learners import base, proto_learner, transformer_learner\n"
        "from r3dfsseg_tpu_torch.models import protonet, transformer\n"
        "from r3dfsseg_tpu_torch.ops import ccns, segment, lp_blocked\n"
        "from r3dfsseg_tpu_torch.ops import cuda_attention, cuda_cheby, cuda_fps, cuda_knn, "
        "cuda_kth, cuda_scatter, cuda_gather, cuda_fused_edge, fused_edge\n"
        "from r3dfsseg_tpu_torch.utils.convert import state_dict_from_jax\n"
        "from r3dfsseg_tpu_torch.config import tiny_config\n"
        "import numpy as np\n"
        "p = FewShotPredictor(tiny_config(), device='cpu')\n"
        "rng = np.random.default_rng(0)\n"
        "sy = np.zeros((2, 2, 64), np.int32); sy[..., :9] = 1\n"
        "out = p.predict(rng.normal(size=(2, 2, 64, 9)), sy, rng.normal(size=(2, 64, 9)))\n"
        "assert out.shape == (2, 64)\n"
        "qy = rng.integers(0, 3, size=(2, 64)).astype(np.int32)\n"
        "m = p._learner.train((rng.normal(size=(2, 2, 64, 9)), sy, rng.normal(size=(2, 64, 9)),\n"
        "                      qy, None, None, np.array([[1, 1], [2, 2]])))\n"
        "assert np.isfinite(float(m['loss']))\n"
        "for phase in ('protoeval', 'transformereval'):\n"
        "    b = FewShotPredictor(tiny_config(phase=phase, d_model=16, n_head=2), device='cpu')\n"
        "    assert b.predict(rng.normal(size=(2, 2, 64, 9)), sy,\n"
        "                     rng.normal(size=(2, 64, 9))).shape == (2, 64)\n"
        "lowp = FewShotPredictor(tiny_config(graph_dtype='bfloat16'), device='cpu')\n"
        "assert lowp.predict(rng.normal(size=(2, 2, 64, 9)), sy,\n"
        "                    rng.normal(size=(2, 64, 9))).shape == (2, 64)\n"
        "xyz = rng.uniform(0, 4, size=(3 * 64 + 5, 3))\n"
        "for impl in ('auto', 'blocked', 'sparse'):\n"
        "    os.environ['R3D_SCENE_LP'] = impl\n"
        "    assert p.predict_scene(rng.normal(size=(2, 2, 64, 9)), sy, xyz).shape == (197,)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'r3dfsseg_tpu.'))\n"
        "             or m in ('r3dfsseg_tpu', 'flax', 'h5py', 'msgpack')\n"
        "             or m.startswith(('flax.', 'h5py.', 'msgpack.')))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
