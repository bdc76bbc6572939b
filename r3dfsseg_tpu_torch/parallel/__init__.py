"""Multi-device scaling of the port (counterpart of `r3dfsseg_tpu/parallel/`):
episode and scene-batch data parallelism on `torch.distributed`
(`mesh.py`), the launcher of its ranks (`launch.py`), and the node-sharded
scene label propagation (`sp.py`), which `serve.py:predict_scene(mesh=...)`
runs."""
from r3dfsseg_tpu_torch.parallel.launch import launch  # noqa: F401
from r3dfsseg_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Shard,
    make_mesh,
    replicate,
    resolve_episode_batch,
    shard_episode,
)
from r3dfsseg_tpu_torch.parallel.sp import (  # noqa: F401
    sp_blocked_label_propagate,
    sp_label_propagate,
)
