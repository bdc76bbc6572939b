"""Episode- and scene-batch data parallelism on `torch.distributed`
(counterpart of `r3dfsseg_tpu/parallel/mesh.py`).

The JAX package splits a batch of E episodes on its leading axis over a
1-D 'data' mesh, replicates the parameters and the optimizer state, and
lets GSPMD insert the reductions.  Here a mesh is W processes, one device
each (`parallel/launch.py` starts them): NCCL between CUDA devices, gloo on
the CPU or between ranks that share one card.  Rank r takes rows
[r E / W, (r + 1) E / W) of the host batch (`shard_episode`), and the
learners (`learners/base.py`) make the reductions that GSPMD made: the
gradient's mean over ranks, the BatchNorm running statistics' mean, the
metrics' mean, and the predictions gathered in episode order.  A batch that
W does not divide runs whole on every rank, with no collective.

The shard's place goes down the model as an argument (`Shard`, never
module state): the attention dropout hashes the global cloud index
(`ops/cuda_attention.py`, ``b0``) and `nn/dgcnn.py:seeded_dropout` draws
the whole batch's mask and keeps the shard's rows, so the sharded step
draws the unsharded step's masks.

    mesh = make_mesh(device="cuda")        # in a rank: cuda:<local rank>
    learner.attach_mesh(mesh)              # parameters, buffers, Adam state from rank 0
    metrics = learner.train(host_batch)    # this rank's rows; the global mean metrics
"""
from __future__ import annotations

import os
from typing import Iterable, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from r3dfsseg_tpu_torch.models.episode import Episode


class Shard(NamedTuple):
    """Where a rank's rows sit in the whole batch along its leading axis:
    rows [offset, offset + rows) of ``total``."""
    offset: int
    total: int

    def scaled(self, k: int) -> "Shard":
        """The same place in units k times finer (an episode's k clouds)."""
        return Shard(self.offset * k, self.total * k)


class Mesh(NamedTuple):
    """The port's mesh: the process group (None without one), this rank,
    the world size and this rank's device."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device

    @property
    def staged_all_gather(self) -> bool:
        """Whether all-gathers go through host copies: gloo gathers CPU
        tensors only, so ranks that share a card over gloo stage them."""
        return (self.group is not None and self.device.type == "cuda"
                and dist.get_backend(self.group) == "gloo")


def rank_device(device, world: int = 1) -> torch.device:
    """This rank's device: cuda:<local rank> for "cuda" (`torchrun`'s
    LOCAL_RANK, which `parallel/launch.py` sets too; 0 outside a launched
    group), any explicit device as given (ranks that share it), else the
    CPU.  Raises where CUDA is asked for and missing, or where this host
    has fewer CUDA devices than its ranks need: LOCAL_WORLD_SIZE of the
    ``world`` ranks (all of them where it is unset)."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    if device.index is not None:
        return device
    have = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if have < local:
        raise RuntimeError(f"a mesh of {world} ranks, {local} on this host, needs {local} CUDA "
                           f"devices here, one per rank; {have} visible")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def mesh_size(cfg, device=None) -> int:
    """The mesh the config asks for: ``mesh_shape[0]`` where given, else
    every visible GPU on a CUDA device, else 1 (the JAX package's
    `len(jax.devices())`)."""
    if cfg.mesh_shape:
        return int(cfg.mesh_shape[0])
    if torch.device("cuda" if device is None else device).type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return 1


def resolve_episode_batch(cfg, log=None, device=None):
    """Resolve the episode-batch auto value (episode_batch == 0, the CLI
    default) to one episode per rank of `mesh_size`, so that episode DP
    engages by itself on a host of many GPUs.  Explicit values pass
    through unchanged.  Returns a config with episode_batch >= 1."""
    if cfg.episode_batch > 0:
        return cfg
    e = mesh_size(cfg, device)
    if e > 1 and log is not None:
        log("auto episode_batch=%d (one episode per device; pass "
            "--episode_batch to override)" % e)
    return cfg.replace(episode_batch=e)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of this process: the default process group when one is
    initialised (`parallel/launch.py`, or `torchrun`), else world size 1.
    ``n_devices``, where given, must be the world size.  ``device`` as
    `rank_device` ("cuda" when None)."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f"make_mesh({n_devices}): no process group; start the ranks "
                               f"with r3dfsseg_tpu_torch.parallel.launch or torchrun")
        return Mesh(None, 0, 1, rank_device(device))
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the process group has {size} ranks")
    return Mesh(dist.group.WORLD, dist.get_rank(), size, rank_device(device, size))


def divides(mesh: Optional[Mesh], rows: int) -> bool:
    """Whether a batch of ``rows`` runs sharded over ``mesh``: a mesh of
    more than one rank that divides it."""
    return mesh is not None and mesh.size > 1 and rows % mesh.size == 0


def shard_rows(x, mesh: Mesh):
    """This rank's rows [r E / W, (r + 1) E / W) of ``x`` along its leading
    axis (numpy or a tensor; None passes)."""
    if x is None:
        return None
    per = x.shape[0] // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def shard_episode(ep: Episode, mesh: Mesh):
    """(this rank's rows of a batched host episode, their global offset):
    only these rows go to the device.  The batch must divide the mesh."""
    e = ep.support_x.shape[0]
    if e % mesh.size:
        raise ValueError(f"shard_episode: {e} episodes do not split over {mesh.size} ranks")
    return Episode(*(shard_rows(a, mesh) for a in ep)), mesh.rank * (e // mesh.size)


# ------------------------------------------------------------ collectives --
def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def all_reduce_mean(tensors: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Each float tensor's mean over the ranks (new tensors of the inputs'
    shapes; all of one dtype and device), in one all-reduce."""
    if not tensors:
        return []
    flat = _flat([t.detach() for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    return _unflat(flat / mesh.size, tensors)


def all_reduce_grads_(params: List[torch.nn.Parameter], mesh: Mesh) -> None:
    """Each parameter's gradient -> its mean over the ranks, in one
    all-reduce.  A gradient that is None on some ranks counts as zero
    there; one that is None on every rank stays None, so Adam skips that
    parameter as it does on one device."""
    dev = mesh.device
    flags = torch.tensor([p.grad is not None for p in params], dtype=torch.float32, device=dev)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([flags, _flat(grads).float()])
    dist.all_reduce(flat, group=mesh.group)
    flags, flat = flat[:len(params)], flat[len(params):]
    flat /= mesh.size
    for p, g, f in zip(params, _unflat(flat, grads), flags.tolist()):
        p.grad = g.to(p.dtype) if f > 0 else None


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along the leading
    axis in rank order; through host copies where the backend gathers
    host tensors only (`Mesh.staged_all_gather`)."""
    src = t.detach().contiguous()
    if mesh.staged_all_gather:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def replicate(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Broadcast each tensor from rank 0 in place (parameters, buffers,
    optimizer state, a generator's state): every rank then starts from
    rank 0's.  A host tensor on an NCCL mesh goes through the device."""
    if mesh.group is None:
        return
    nccl = dist.get_backend(mesh.group) == "nccl"
    with torch.no_grad():
        for t in tensors:
            if nccl and t.device.type != "cuda":
                d = t.to(mesh.device)
                dist.broadcast(d, 0, group=mesh.group)
                t.copy_(d.cpu())
            else:
                dist.broadcast(t, 0, group=mesh.group)


def sync_group(mesh: Optional[Mesh]):
    """The group over which synchronised BatchNorm sums its statistics: the
    mesh's where it has more than one rank, else None (one rank's
    statistics are the batch's, and a collective there would only round
    differently)."""
    return mesh.group if mesh is not None and mesh.size > 1 else None
