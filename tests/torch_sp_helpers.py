"""Rank bodies of tests/test_torch_sp.py: `r3dfsseg_tpu_torch.parallel.launch`
runs `run_sp_cases` in spawned gloo ranks on the CPU, and the tests call it
in-process for a mesh of one.  A spawned rank re-imports this module, so it
imports the port and torch only; the parent test computes the JAX side and
passes numpy arrays in.  Each rank takes one CPU thread."""
from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

from r3dfsseg_tpu_torch.config import tiny_config
from r3dfsseg_tpu_torch.ops import lp_blocked
from r3dfsseg_tpu_torch.parallel import Mesh, make_mesh, sp_blocked_label_propagate, \
    sp_label_propagate
from r3dfsseg_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_max
from r3dfsseg_tpu_torch.parallel.sp import sp_blocked_plan
from r3dfsseg_tpu_torch.serve import FewShotPredictor


def _same_on_ranks(z: torch.Tensor, mesh: Mesh) -> bool:
    """Whether every rank holds the same bits of z."""
    every = all_gather_rows(z[None].contiguous(), mesh)
    return bool((every == z[None]).all())


def dense_case(case: dict, mesh: Mesh) -> dict:
    z = sp_label_propagate(torch.from_numpy(case["feat"]), torch.from_numpy(case["y"]),
                           mesh=mesh, valid=torch.from_numpy(case["valid"]), **case["kw"])
    return {"z": z.numpy(), "same_on_ranks": _same_on_ranks(z, mesh)}


def blocked_case(case: dict, mesh: Mesh) -> dict:
    """The blocked sharded graph; ``case['budget']`` replaces the stored
    graph's byte budget for the call (the split store at a small M)."""
    budget = lp_blocked.STORE_BUDGET
    lp_blocked.STORE_BUDGET = case.get("budget", budget)
    try:
        m = case["feat"].shape[0]
        mode = sp_blocked_plan(m, mesh.size, row_tile=case["kw"]["row_tile"],
                               store_graph=case["kw"].get("store_graph"))[1]
        z = sp_blocked_label_propagate(
            torch.from_numpy(case["feat"]), torch.from_numpy(case["y"]), mesh=mesh,
            valid=torch.from_numpy(case["valid"]), **case["kw"])
    finally:
        lp_blocked.STORE_BUDGET = budget
    return {"z": z.numpy(), "mode": mode, "same_on_ranks": _same_on_ranks(z, mesh)}


def max_case(case: dict, mesh: Mesh) -> dict:
    """The max all-reduce of rank + 0.5, which every rank must read."""
    got = all_reduce_max(torch.tensor(mesh.rank + 0.5), mesh)
    every = all_gather_rows(got[None], mesh)
    return {"max": float(got), "every": every.tolist()}


def scene_case(case: dict, mesh: Mesh) -> dict:
    """`predict_scene(mesh=...)` under R3D_SCENE_LP=case['route'] on the
    tiny model with ``case['weights']`` (Flax params, batch stats)."""
    port = FewShotPredictor(tiny_config(lp_cg_iters=10), device="cpu")
    port._learner.load_params(*case["weights"])
    saved = os.environ.get("R3D_SCENE_LP")
    os.environ["R3D_SCENE_LP"] = case["route"]
    try:
        labels = port.predict_scene(*case["args"], mesh=mesh)
    finally:
        if saved is None:
            del os.environ["R3D_SCENE_LP"]
        else:
            os.environ["R3D_SCENE_LP"] = saved
    every = all_gather_rows(torch.from_numpy(labels)[None], mesh)
    return {"labels": labels, "same_on_ranks": bool((every == every[0]).all())}


CASES = {"dense": dense_case, "blocked": blocked_case, "max": max_case, "scene": scene_case}


def run_sp_cases(cases: dict, device="cpu") -> dict:
    """Every case in order on this process's mesh: a launched rank's, or a
    mesh of one with no group; {name: rank 0's result}."""
    if dist.is_initialized():
        torch.set_num_threads(1)
        sys.modules["torch.utils.tensorboard"] = None
        mesh = make_mesh(device=device)
    else:
        mesh = Mesh(None, 0, 1, torch.device(device))
    return {name: CASES[case["run"]](case, mesh) for name, case in cases.items()}
