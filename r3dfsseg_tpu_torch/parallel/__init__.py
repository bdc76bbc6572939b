"""Multi-device scaling of the port (counterpart of `r3dfsseg_tpu/parallel/`):
episode and scene-batch data parallelism on `torch.distributed`
(`mesh.py`) and the launcher of its ranks (`launch.py`).  The node-sharded
scene label propagation of the JAX package's `sp.py` is not ported yet
(ROADMAP.md section 1, item 7b)."""
from r3dfsseg_tpu_torch.parallel.launch import launch  # noqa: F401
from r3dfsseg_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Shard,
    make_mesh,
    replicate,
    resolve_episode_batch,
    shard_episode,
)
