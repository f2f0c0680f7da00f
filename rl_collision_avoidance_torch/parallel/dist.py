"""Data parallelism over processes: the arenas shard by rank, the policy
and Adam are replicated, and the gradients are summed across ranks.

Counterpart of ``rl_collision_avoidance_tpu/parallel/mesh.py``.  Where the
JAX package lays the arenas along a mesh axis and lets XLA insert the
gradient ``psum``, the port runs one process a rank (the reference's MPI
world, ``ppo_stage1.py:66-75``) and calls the collectives itself.  Every
function here works on the default process group, and is the identity or
a no-op when no group is initialized, so a one-process run takes today's
path unchanged.

The training path uses two collectives only, ``all_reduce`` and
``broadcast``: gloo takes CUDA tensors for those two alone (``all_gather``
on CUDA is NCCL's), and two ranks that share one card must use gloo,
because NCCL refuses to put two ranks on one device.  So
:func:`all_gather_flat` is an ``all_reduce`` of a zero-filled buffer in
which each rank has written its own slice: adding zeros is exact, so the
result is bit-equal to a gather on every backend.
"""
from __future__ import annotations

import socket

import torch
import torch.distributed as dist

#: Rank r seeds its generators with ``seed + RANK_SEED_STRIDE * r``: rank 0
#: draws what a one-process run draws, and no two ranks share a stream.
RANK_SEED_STRIDE = 1_000_003


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The ranks in the process group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def rank_seed(seed: int) -> int:
    """The seed of this rank's generators (see :data:`RANK_SEED_STRIDE`)."""
    return seed + RANK_SEED_STRIDE * rank()


def arena_range(n_arenas: int) -> tuple[int, int]:
    """The arenas [lo, hi) this rank owns: rank r of W owns [r A / W,
    (r + 1) A / W), so the arena-major global batch stays shard-contiguous
    (``rl_collision_avoidance_tpu/train/trainer.py:242-246``).  Raises
    unless W divides A."""
    w, r = world_size(), rank()
    if n_arenas % w:
        raise ValueError(f"{n_arenas} arenas do not divide over {w} ranks")
    return r * n_arenas // w, (r + 1) * n_arenas // w


def local_device(process_id: int | None = None) -> torch.device:
    """The card of process ``process_id`` (this rank): ``cuda:{id %
    device_count}``.  Raises when there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "the ranks on the CPU with gloo")
    r = rank() if process_id is None else process_id
    return torch.device("cuda", r % torch.cuda.device_count())


def _device_id(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def _check_one_rank_a_device(device: torch.device) -> None:
    """Raise when another rank of the NCCL group runs on ``device``: NCCL
    refuses it at the first collective ("Duplicate GPU detected"); this
    says so at setup, through the group's store, before any collective."""
    store = dist.distributed_c10d._get_default_store()
    me = _device_id(device)
    store.set(f"rca_device/{rank()}", me)
    owners = [r for r in range(world_size())
              if store.get(f"rca_device/{r}").decode() == me]
    if len(owners) > 1:
        dist.destroy_process_group()
        raise RuntimeError(
            f"NCCL takes one rank a device, but ranks {owners} all run on "
            f"{device} ({me}): run one process a card, or share one card "
            f"between ranks with backend='gloo'")


def setup_distributed(coordinator: str | None = None,
                      num_processes: int | None = None,
                      process_id: int | None = None,
                      backend: str | None = None,
                      device=None) -> torch.device | None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, through ``coordinator`` (``IP:PORT`` of rank 0, or an
    ``init_method`` URL such as ``file:///tmp/store``); a no-op returning
    None when ``coordinator`` is None.  Run it before any other CUDA use.

    ``device`` is this rank's (default :func:`local_device`).  The backend
    is NCCL for a CUDA device and gloo for the CPU; ``backend="gloo"`` runs
    CUDA tensors through gloo, so that two ranks can share one card.  NCCL
    with two ranks on one device raises.  Returns the rank's device."""
    if coordinator is None:
        if num_processes not in (None, 1):
            raise ValueError("--num-processes > 1 needs a coordinator")
        return None
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    device = (local_device(process_id) if device is None
              else torch.device(device))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL runs on CUDA devices, not {device}")
        torch.cuda.set_device(device)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    if backend == "nccl":
        _check_one_rank_a_device(device)
    return device


def teardown() -> None:
    """Leave the process group, if there is one."""
    if is_initialized():
        dist.destroy_process_group()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place (every rank gets the same
    bits); ``t`` itself without a group."""
    if is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_gather_flat(local: torch.Tensor) -> torch.Tensor:
    """The ranks' equally sized ``local`` tensors, flattened and laid end
    to end in rank order: an all-reduce of zeros around each rank's slice
    (see the module docstring).  ``local`` flattened without a group."""
    flat = local.reshape(-1)
    if not is_initialized():
        return flat
    n, r = flat.numel(), rank()
    out = torch.zeros(world_size() * n, dtype=flat.dtype, device=flat.device)
    out[r * n:(r + 1) * n] = flat
    return all_reduce_sum(out)


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to rank 0's, in place;
    returns ``module``."""
    if is_initialized():
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, 0)
    return module
