"""Rank bodies of tests/test_torch_parallel.py: functions that
`r3dfsseg_tpu_torch.parallel.launch` runs in spawned gloo ranks on the
CPU, and that the tests also call in-process for the unsharded side.  A
spawned rank re-imports this module, so it imports the port and torch
only; the parent test computes the JAX side and passes numpy arrays in.
Each rank body returns rank 0's view as numpy arrays, and takes one CPU
thread: the ranks and the other test workers share the cores."""
from __future__ import annotations

import sys

import torch
import torch.distributed as dist

from r3dfsseg_tpu_torch import eval_noise, mpti_train_noise, pretrain
from r3dfsseg_tpu_torch.learners import MPTILearner, ProtoLearner, TransformerLearner
from r3dfsseg_tpu_torch.models.episode import Episode
from r3dfsseg_tpu_torch.nn.dgcnn import BatchNorm, init_linear_weights
from r3dfsseg_tpu_torch.parallel import make_mesh
from r3dfsseg_tpu_torch.parallel.mesh import all_gather_rows, shard_rows, sync_group
from r3dfsseg_tpu_torch.pretrain import pretrain_step, seg_model


def make_learner(kind: str, cfg, device="cpu"):
    if kind == "mpti":
        return MPTILearner(cfg, device)
    if kind == "proto":
        return ProtoLearner(cfg, device, with_contrast=True)
    if kind == "transformer":
        return TransformerLearner(cfg, device)
    raise ValueError(kind)


def _numpy(t):
    return None if t is None else t.detach().cpu().numpy().copy()


def learner_case(case: dict, mesh=None) -> dict:
    """One learner on ``case['batch']`` (an Episode of numpy arrays): its
    predictions in eval, then one training step; with a ``mesh`` the
    learner takes it first.  ``case['weights']`` (Flax params, batch
    stats) replaces the seeded weights."""
    learner = make_learner(case["kind"], case["cfg"])
    if case.get("weights") is not None:
        learner.load_params(*case["weights"])
    if mesh is not None:
        learner.attach_mesh(mesh)
    batch = Episode(*case["batch"])
    pred = learner.test(batch)[0]
    metrics = learner.train(batch)
    model = learner.model
    return {"pred": _numpy(pred),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: _numpy(p.grad) for k, p in model.named_parameters()},
            "params": {k: _numpy(p) for k, p in model.named_parameters()},
            "buffers": {k: _numpy(b) for k, b in model.named_buffers()
                        if k.endswith(("running_mean", "running_var"))}}


def pretrain_case(case: dict, mesh=None) -> dict:
    """One pretraining step on ``case['x']``, ``case['y']`` (the whole
    batch; a mesh's rank takes its rows), from seeded weights."""
    cfg = case["cfg"]
    gen = torch.Generator().manual_seed(cfg.seed)
    model = seg_model(cfg, case["classes"])
    init_linear_weights(model, gen)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    x, y = torch.as_tensor(case["x"]), torch.as_tensor(case["y"])
    offset = 0
    if mesh is not None:
        x, y = shard_rows(x, mesh), shard_rows(y, mesh)
        offset = mesh.rank * x.shape[0]
    loss, acc = pretrain_step(model, opt, x, y, gen, mesh, offset)
    return {"loss": float(loss), "acc": float(acc),
            "grads": {k: _numpy(p.grad) for k, p in model.named_parameters()},
            "buffers": {k: _numpy(b) for k, b in model.named_buffers()}}


def bn_case(case: dict, mesh=None) -> dict:
    """Train-mode BatchNorm on ``case['x']`` (B, N, C), with statistics
    synchronised over the mesh's ranks (each taking its rows), and the
    input gradient of sum(y * dy): the whole batch's y and dx (gathered in
    rank order) and the running statistics."""
    x, dy = torch.as_tensor(case["x"]), torch.as_tensor(case["dy"])
    if mesh is not None:
        x, dy = shard_rows(x, mesh), shard_rows(dy, mesh)
    bn = BatchNorm(x.shape[-1], fast=case["fast"])
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(case["weight"]))
        bn.bias.copy_(torch.as_tensor(case["bias"]))
    x = x.clone().requires_grad_(True)
    y = bn(x, train=True, sync=sync_group(mesh))
    (y * dy).sum().backward()
    y, dx = y.detach(), x.grad
    if mesh is not None:
        y, dx = all_gather_rows(y, mesh), all_gather_rows(dx, mesh)
    return {"y": _numpy(y), "dx": _numpy(dx), "running_mean": _numpy(bn.running_mean),
            "running_var": _numpy(bn.running_var)}


CASES = {"learner": learner_case, "pretrain": pretrain_case, "bn": bn_case}


def run_cases(cases, device="cpu"):
    """Every case in order, on this process's mesh where a process group
    is initialised (a launched rank), else unsharded; {name: result}."""
    mesh = None
    if dist.is_initialized():
        torch.set_num_threads(1)
        mesh = make_mesh(device=device)
    return {name: CASES[case["run"]](case, mesh) for name, case in cases.items()}


def cli_chain(train_cfg, eval_cfg, pretrain_cfg, device="cpu"):
    """The CLIs' runs in a launched rank (each sees the process group and
    takes its mesh): training, the evaluation of ``eval_cfg``'s
    checkpoint and pretraining at batch 8; (train's figures, the mean
    IoU, the pretraining checkpoint's path).  TensorBoard is blocked, as
    in this rank's parent: `torch.utils.tensorboard` imports TensorFlow
    here, which takes seconds."""
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None
    return (mpti_train_noise.train(train_cfg, device=device),
            eval_noise.evaluate(eval_cfg, device=device),
            pretrain.pretrain(pretrain_cfg, batch_size=8, device=device))


def fail_on_rank_one(device="cpu"):
    """Rank 1 raises while rank 0 waits in a collective: the launcher must
    stop rank 0 and raise rank 1's error."""
    if dist.get_rank() == 1:
        raise ValueError("rank one failed on purpose")
    dist.barrier()
    return "unreachable"
