"""Several processes (counterpart of mcpt_tpu/parallel/distributed.py):
one torch.distributed job, one process a host, the film's pixels sharded
over the global mesh, which is the processes' local meshes in rank order.

Each process renders only its own shards and collects them on its first
device before any collective, so that every collective has one device a
process.  The only traffic is the train step's all-reduce of the loss and
the gradients (parallel/shard.py::make_train_step) and the film's
all-gather at the end of a frame.  The per-pixel Tea/LCG streams make the
film bit-equal for any process and device layout.

Collectives run on the first device's CUDA tensors over NCCL, and on host
copies over gloo (which also serves two processes that share one card:
NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> None:
    """Join (or form) the job.  The arguments default to the
    MCPT_COORDINATOR ("host:port"), MCPT_NUM_PROCS and MCPT_PROC_ID
    environment variables; with neither an address nor a process count
    this is a no-op, so that single-host scripts may call it always.
    `backend`: "nccl" where CUDA is present, else "gloo", unless named."""
    coordinator_address = (coordinator_address
                           or os.environ.get("MCPT_COORDINATOR"))
    if num_processes is None and "MCPT_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["MCPT_NUM_PROCS"])
    if process_id is None and "MCPT_PROC_ID" in os.environ:
        process_id = int(os.environ["MCPT_PROC_ID"])
    if coordinator_address is None and num_processes is None:
        return  # a single process
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator's address, "
                         "the process count and this process's id "
                         "(MCPT_COORDINATOR, MCPT_NUM_PROCS, MCPT_PROC_ID)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(0)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def _comm_device(mesh):
    """Where a collective's tensor lies: the first device over NCCL, the
    host otherwise."""
    if dist.get_backend() == "nccl":
        return mesh[0]
    return torch.device("cpu")


def _mesh_sizes(mesh) -> list:
    """Every process's local mesh size, in rank order."""
    mine = torch.tensor([len(mesh)], dtype=torch.int64,
                        device=_comm_device(mesh))
    sizes = [torch.zeros_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(sizes, mine)
    return [int(x) for x in sizes]


def mesh_slot(mesh) -> tuple:
    """(this process's first device in the global mesh, the global mesh's
    size): (0, len(mesh)) without a process group."""
    if not _joined():
        return 0, len(mesh)
    sizes = _mesh_sizes(mesh)
    return sum(sizes[:dist.get_rank()]), sum(sizes)


def all_reduce_sum(loss, grads: dict):
    """loss and every gradient summed over the process group (one
    all-reduce of them packed together), on the devices they came on;
    as they are without a process group."""
    if not _joined():
        return loss, grads
    dev = loss.device
    keys = list(grads)
    flat = torch.cat([loss.reshape(1)] + [grads[k].reshape(-1) for k in keys])
    buf = flat.to(_comm_device((dev,)))
    dist.all_reduce(buf)
    buf = buf.to(dev)
    out, at = {}, 1
    for k in keys:
        size = grads[k].numel()
        out[k] = buf[at:at + size].view_as(grads[k])
        at += size
    return buf[0], out


def render_film_multihost(scene, camera, integ, spp: int,
                          frame_base: int = 0, mesh=None) -> np.ndarray:
    """The film over every device of the job, [H*W, 3] f32 numpy on every
    process.  `mesh`: this process's devices, by default make_mesh() (every
    CUDA device it sees).  With one process it is render_film_sharded over
    that mesh; with several, this process renders its own shards of the
    global mesh, and the film is all-gathered."""
    from mcpt_tpu_torch.parallel.shard import (film_shards, make_mesh,
                                               render_film_sharded,
                                               render_shards)

    mesh = make_mesh() if mesh is None else tuple(mesh)
    if not _joined() or dist.get_world_size() == 1:
        return render_film_sharded(scene, camera, integ, mesh, spp,
                                   frame_base).cpu().numpy()
    sizes = _mesh_sizes(mesh)
    rank, world = dist.get_rank(), dist.get_world_size()
    first, n_dev = sum(sizes[:rank]), sum(sizes)
    n_pix = camera.width * camera.height
    shards = film_shards(n_pix, n_dev)
    per = shards[0].shape[0]
    films = render_shards(scene, camera, integ, mesh,
                          shards[first:first + len(mesh)], spp, frame_base)
    local = torch.cat([f.to(mesh[0]) for f in films])
    # equal parts for the all-gather: each process's part padded to the
    # largest local mesh's rows
    rows = max(sizes) * per
    if local.shape[0] < rows:
        local = torch.cat([local, local.new_zeros((rows - local.shape[0], 3))])
    comm = _comm_device(mesh)
    local = local.to(comm).contiguous()
    if comm.type == "cuda":
        out = local.new_empty((world * rows, 3))
        dist.all_gather_into_tensor(out, local)
        parts = list(out.split(rows))
    else:
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local)
    film = torch.cat([p[:s * per] for p, s in zip(parts, sizes)])
    return film[:n_pix].cpu().numpy()
