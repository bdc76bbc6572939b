"""The port's R3DConfig is the JAX package's, field by field."""
import dataclasses
import pathlib
import subprocess
import sys

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


def test_port_imports_no_jax():
    """Importing the port, its serving path and its training step pulls in
    neither jax nor the JAX package (a fresh interpreter, so this process's
    jax does not count)."""
    code = (
        "import sys\n"
        "import r3dfsseg_tpu_torch, chip_smoke\n"
        "from r3dfsseg_tpu_torch.serve import FewShotPredictor\n"
        "from r3dfsseg_tpu_torch.learners.mpti_learner import MPTILearner\n"
        "from r3dfsseg_tpu_torch.ops import cuda_attention, cuda_cheby, cuda_fps, cuda_knn, "
        "cuda_kth, cuda_scatter\n"
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
        "lowp = FewShotPredictor(tiny_config(graph_dtype='bfloat16'), device='cpu')\n"
        "assert lowp.predict(rng.normal(size=(2, 2, 64, 9)), sy,\n"
        "                    rng.normal(size=(2, 64, 9))).shape == (2, 64)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'r3dfsseg_tpu.'))\n"
        "             or m == 'r3dfsseg_tpu' or m == 'flax')\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
