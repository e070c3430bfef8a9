"""Data parallelism over ``torch.distributed``: one process per card.

Counterpart of ``semantic_abstraction_tpu/parallel/mesh.py``. The JAX
package runs one jitted step over a 1-D ``Mesh(("data",))``; the port runs
one process per card, launched as ``torch.distributed.run`` launches it
(``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``
in the environment), and its train step goes through
``DistributedDataParallel``:

    python -m torch.distributed.run --nproc_per_node N \\
        -m semantic_abstraction_tpu_torch.cli.train_ovssc --num_devices N ...

What the JAX names mean here:
- ``maybe_initialize_distributed`` initializes the default process group
  when ``WORLD_SIZE`` > 1 or ``SEMABS_DISTRIBUTED=1``: ``nccl`` on the card
  (after ``torch.cuda.set_device(LOCAL_RANK)``), ``gloo`` when the caller
  asked for the CPU. It returns the device this process runs on.
- ``world_size`` / ``rank`` stand in for ``process_count`` /
  ``process_index``.
- ``all_gather_host_objects`` is ``dist.all_gather_object``.
- ``mesh_size_from_args`` is the data-parallel group size; ``--num_devices
  1`` turns DDP off.

Not ported: ``make_mesh``, ``shard_batch`` and the shardings. Each rank
loads its own shard of the index space (``data.ShardedSampler``) and runs
its forward on its own rows, so no global array is assembled.
"""
from __future__ import annotations

import os
from typing import Callable, List

import torch
import torch.distributed as dist
from torch import nn

LAUNCH_HINT = "launch with python -m torch.distributed.run --nproc_per_node N"


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Processes in the default group (1 when there is none)."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group (0 when there is none)."""
    return dist.get_rank() if is_initialized() else 0


def maybe_initialize_distributed(device=None) -> torch.device:
    """Initialize the default process group when a multi-process launch is
    configured (``WORLD_SIZE`` > 1 or ``SEMABS_DISTRIBUTED=1``) and return
    the device this process runs on: ``cuda:LOCAL_RANK`` (made current) for
    a ``cuda`` device, else ``device``. A no-op in a single process, and
    when the group exists already (its backend is then the caller's).
    ``device`` is ``cuda`` unless the caller asks for another."""
    dev = torch.device("cuda" if device is None else device)
    want = (int(os.environ.get("WORLD_SIZE", "1")) > 1
            or os.environ.get("SEMABS_DISTRIBUTED") == "1")
    if not want and not is_initialized():
        return dev
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to run the "
                               "ranks on the CPU over gloo")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev


def destroy_distributed() -> None:
    """Tear the default process group down, if there is one."""
    if is_initialized():
        dist.destroy_process_group()


def all_gather_host_objects(obj) -> List[object]:
    """Every rank's picklable ``obj``, in rank order, on every rank
    (reference ``dist.all_gather_object`` of the detailed-stats frames,
    utils.py:433-435); ``[obj]`` in a single process."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def mesh_size_from_args(args) -> int:
    """Cards in the data-parallel group: ``--num_devices``, or the world
    size when it is unset; 1 turns DDP off. Any other value must be the
    world size, since the port runs one process per card."""
    n = getattr(args, "num_devices", None)
    if n is None or n == 1:
        return world_size() if n is None else 1
    if n != world_size():
        raise SystemExit(
            f"--num_devices {n} under a world size of {world_size()}: each process "
            f"drives one card; {LAUNCH_HINT.replace('N', str(n))}")
    return n


def data_parallel_from_args(args) -> bool:
    """Whether the train step goes through DDP: a process group exists and
    ``--num_devices`` is not 1 (a world of one process included)."""
    return is_initialized() and getattr(args, "num_devices", None) != 1


class ForwardLoss(nn.Module):
    """A net and its forward-loss as one module, for DDP: the port's
    forward-losses reach into the net's submodules, and DDP's reducer arms
    only inside ``DDP.forward``, so wrapping the bare net would leave the
    gradients unsynchronised without any error."""

    def __init__(self, model: nn.Module, forward_loss: Callable, cfg,
                 balance_positive_negative: bool, compute_dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.forward_loss = forward_loss
        self.cfg = cfg
        self.balance_positive_negative = balance_positive_negative
        self.compute_dtype = compute_dtype

    def forward(self, batch: dict):
        return self.forward_loss(self.model, self.cfg, batch,
                                 self.balance_positive_negative, self.compute_dtype)


def data_parallel(model: nn.Module, forward_loss: Callable, cfg,
                  balance_positive_negative: bool = False,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  find_unused_parameters: bool = False
                  ) -> nn.parallel.DistributedDataParallel:
    """``model`` under its forward-loss, data-parallel over the default
    group. DDP broadcasts rank 0's weights when it is built and averages
    the gradients over the ranks in ``backward``. ``find_unused_parameters``
    is for a net with parameters its forward never reads: plain DDP raises
    on the second step there, and with it their ``.grad`` stays None on
    every rank."""
    dev = next(model.parameters()).device
    return nn.parallel.DistributedDataParallel(
        ForwardLoss(model, forward_loss, cfg, balance_positive_negative, compute_dtype),
        device_ids=[dev] if dev.type == "cuda" else None,
        find_unused_parameters=find_unused_parameters,
    )
