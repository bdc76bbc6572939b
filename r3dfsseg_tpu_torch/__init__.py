"""r3dfsseg_tpu_torch: the PyTorch/CUDA port of r3dfsseg_tpu for NVIDIA
Hopper (H100).

The JAX package `r3dfsseg_tpu` stays the reference; each module here
mirrors its counterpart's path.  Every TPU Pallas kernel on the ported path
has a hand-written CUDA kernel in `csrc/`, built with nvcc at first use on
a CUDA tensor (`kernels/build.py`) and wrapped, beside its plain PyTorch
version, in an `ops/cuda_*.py` module.  This package never imports jax.

Ported so far: the eval-mode MPTI+MDNS serving path
(`serve.FewShotPredictor.predict`) and the MPTI + attention + WayContrast
meta-training step (`learners.mpti_learner.MPTILearner.train`), with the
float32 encoder on a float32 or bf16 episode graph (`graph_dtype`).  Both
run on "cuda" unless the caller passes device="cpu".  Beside them, as in
the JAX package, the one-hot row gather (`ops/cuda_gather.py`) and the
archived fused EdgeConv tail (`ops/fused_edge.py`), which no entry point
calls.
"""
import torch


def pin_f32_matmul() -> None:
    """Keep float32 matmuls and convolutions out of TF32, as the JAX
    package's float32 path runs at Precision.HIGHEST."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
