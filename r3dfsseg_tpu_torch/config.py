"""Configuration for the PyTorch/CUDA port.

Field names and defaults are the JAX package's `R3DConfig`, field by field
(pinned by tests/test_torch_config.py), so one set of flags drives both
packages.  The module is defined here rather than imported because the
JAX package's `__init__` imports jax, which the port's machines lack.

The `*_impl` knobs keep their JAX meaning: ``"auto"`` is the hand-written
kernel on a CUDA tensor and the plain PyTorch version on a CPU tensor;
``"xla"`` is the plain PyTorch version everywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple


@dataclasses.dataclass
class R3DConfig:
    # ------------------------------------------------------------------ data
    phase: str = "mptitrain"
    dataset: str = "s3dis"
    cvfold: int = 0
    pretrain_checkpoint_path: Optional[str] = None
    model_checkpoint_path: Optional[str] = None
    save_path: str = "./log_s3dis/"
    eval_interval: int = 2000
    data_path: str = ""
    clean_data_path: str = ""
    log_dir: str = "debug"

    # -------------------------------------------------------- optimization
    batch_size: int = 1
    n_workers: int = 8
    n_iters: int = 40000
    lr: float = 0.001
    encoder_lr: float = 0.0001
    step_size: int = 5000
    gamma: float = 0.5

    # ------------------------------------------------------ episode setting
    n_way: int = 2
    k_shot: int = 5
    n_queries: int = 1
    n_episode_test: int = 100

    # --------------------------------------------------------- point clouds
    pc_npts: int = 2048
    pc_attribs: str = "xyzrgbXYZ"
    pc_augm: bool = False
    pc_augm_scale: float = 0.0
    pc_augm_rot: int = 1
    pc_augm_mirror_prob: float = 0.0
    pc_augm_jitter: int = 1

    # ------------------------------------------------------------- backbone
    dgcnn_k: int = 20
    edgeconv_widths: Tuple[Tuple[int, ...], ...] = ((64, 64), (64, 64), (64, 64))
    dgcnn_mlp_widths: Tuple[int, ...] = (512, 256)
    base_widths: Tuple[int, ...] = (128, 64)
    output_dim: int = 64
    use_attention: bool = True
    dg_atten_dim: int = 128
    attn_dropout: float = 0.1

    # --------------------------------------------------------------- models
    dist_method: str = "cosine"
    n_subprototypes: int = 100
    k_connect: int = 200
    sigma: float = 1.0                     # <= 0: auto bandwidth
    lp_alpha: float = 0.99
    contrast_weight: float = 0.1
    contrast_fps_k: int = 4
    contrast_temp: float = 0.1
    proj_dim: int = 128
    mdns_scales: Tuple[Tuple[int, int, int], ...] = ((1, 1, 1), (2, 2, 1))
    shot_seed: int = 1

    # Transformer baseline architecture
    d_model: int = 128
    n_head: int = 8
    n_layers: int = 3
    d_feed: int = 128

    # ---------------------------------------------------------------- noise
    noise_ratio: float = 0.0
    noise_type: str = "sym"
    noise_pair_dict: Optional[Dict[int, int]] = None
    train_noise_ratio: Sequence[float] = (0.2,)
    ReturnCluster: bool = False
    save_test_record: bool = False

    # ----------------------------------------------------------------- misc
    seed: int = 123

    # ------------------------------------------- implementation knobs
    episode_batch: int = 1
    lp_solver: str = "cheby"               # cheby | cg | solve
    lp_cg_iters: int = 50
    lp_adjoint_iters: int = 0
    wire_format: str = "int8"
    transfer_batch: int = 8
    knn_impl: str = "auto"                 # auto | pallas_exact | pallas | xla
    fps_impl: str = "auto"                 # auto | pallas | xla
    attn_impl: str = "auto"                # auto | pallas | xla
    affinity_impl: str = "threshold"       # threshold | topk
    compute_dtype: str = "float32"         # float32 | bfloat16 (the encoder)
    graph_dtype: str = "auto"              # auto | float32 | bfloat16 (the episode graph)
    attn_f32: bool = False                 # bf16 encoder: f32 attention operands
    bn_mode: str = "fastvar"               # BN precision under the bf16 encoder
    exact_grad_gather: bool = False
    fuse_edge: str = "auto"
    mesh_shape: Optional[Tuple[int, ...]] = None
    profile_dir: Optional[str] = None

    # ---------------------------------------------------------- derived ---
    @property
    def pc_in_dim(self) -> int:
        return len(self.pc_attribs)

    @property
    def n_classes(self) -> int:
        return self.n_way + 1

    @property
    def feat_dim(self) -> int:
        """192 = level1(64) + attention(64) + base(64)."""
        return self.edgeconv_widths[0][-1] + self.output_dim + self.base_widths[-1]

    @property
    def num_proto_slots(self) -> int:
        return self.n_subprototypes * (self.n_way + 1)

    @property
    def num_query_points(self) -> int:
        return self.n_queries * self.n_way * self.pc_npts

    @property
    def num_nodes(self) -> int:
        """Label-propagation graph size: prototype slots ++ query points."""
        return self.num_proto_slots + self.num_query_points

    @property
    def follower_impl(self) -> str:
        """The impl of the kernels that follow the kNN (the scatter-add in
        EdgeConv's backward, the k-th distance, the Chebyshev solve):
        'xla' under knn_impl 'xla', 'auto' under every kernel value."""
        return "xla" if self.knn_impl == "xla" else "auto"

    @property
    def graph_bf16(self) -> bool:
        """Whether the episode graph is bf16: `graph_dtype`, where 'auto'
        follows the encoder's `compute_dtype`."""
        gd = self.compute_dtype if self.graph_dtype == "auto" else self.graph_dtype
        return gd == "bfloat16"

    def replace(self, **kw) -> "R3DConfig":
        return dataclasses.replace(self, **kw)


def tiny_config(**overrides) -> R3DConfig:
    """A miniature config for CPU tests."""
    cfg = R3DConfig(
        n_way=2, k_shot=2, n_queries=1, pc_npts=64,
        dgcnn_k=4, edgeconv_widths=((8, 8), (8, 8), (8, 8)),
        dgcnn_mlp_widths=(16, 16), base_widths=(8, 8), output_dim=8,
        dg_atten_dim=8, n_subprototypes=8, k_connect=8,
        contrast_fps_k=2, proj_dim=8, lp_cg_iters=30,
    )
    return cfg.replace(**overrides)
