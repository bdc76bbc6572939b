"""Single-head attention forward: the Hopper kernel `csrc/attention_fwd.cu`
and its plain version.

Replaces the TPU kernel `r3dfsseg_tpu/ops/pallas_attention.py:_fwd_impl`
(`_attn_fwd_kernel`) in eval mode.  Training (dropout on the attention map
and the backward `_attn_bwd_kernel`) is still to be ported.

What bounds it on the H100: 2 x B x N^2 x D multiply-adds (12 x 2048^2 x
64 at the flagship shape, 6.4 G), run as FP32 FFMA on CUDA cores (no TF32,
as the JAX f32 path keeps full precision).  The plain version writes the
(B, N, N) score matrix (200 MB) to device memory, reads it back for the
softmax and again for the product with v.  The kernel is flash-style: K/V
tiles in shared memory, scores and the output as 4 x 4 register tiles per
thread, an online softmax per row, so scores never leave the SM.

Numerics: the kernel multiplies q by 1/tau (as the TPU kernel does); the
plain version divides q by tau (as the JAX package's XLA path does).  At
the flagship D = 64, tau = 8 and the two are bit-identical; the sum order
differs, which the stated tolerance (rtol 1e-4, atol 1e-5) covers.

Dispatch: a CPU tensor takes `attention_reference`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from r3dfsseg_tpu_torch.kernels import build

MAX_D = 64        # head width: one 64-wide register tile in csrc/attention_fwd.cu

launches = 0


def _no_dropout(rate: float, train: bool) -> None:
    if train and rate > 0.0:
        raise NotImplementedError(
            "attention dropout and its backward come with the training "
            "port (ROADMAP.md, queue item 1)")


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        tau: float, rate: float = 0.0,
                        train: bool = False) -> torch.Tensor:
    """softmax(q k^T / tau) v for (B, N, D) tensors, the plain version."""
    _no_dropout(rate, train)
    s = torch.matmul(q / tau, k.transpose(-1, -2))
    return torch.matmul(torch.softmax(s, dim=-1), v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, tau: float,
              rate: float = 0.0, train: bool = False) -> torch.Tensor:
    """softmax(q k^T / tau) v; q, k, v (B, N, D) f32 -> (B, N, D) f32."""
    global launches
    _no_dropout(rate, train)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, tau)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no kernel for device {q.device}")
    if not (q.shape == k.shape == v.shape and q.dim() == 3):
        raise ValueError(f"attention: want equal (B, N, D) shapes, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype == torch.float32:
        raise ValueError("attention: want float32 q, k, v")
    b, n, d = q.shape
    if not (b > 0 and n > 0 and 0 < d <= MAX_D and d % 4 == 0):
        raise ValueError(f"attention: unsupported shape B={b} N={n} D={d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    y = torch.empty_like(q)
    fn = build.function("r3d_attn_fwd", [build.P, build.P, build.P, build.P, build.I,
                                         build.I, build.I, build.F, build.P])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(), b, n, d,
                 1.0 / tau, build.stream_ptr(q.device))
    build.check(err, "r3d_attn_fwd")
    launches += 1
    return y
