"""Multi-process runtime of the landmark-sharded BA, over torch.distributed.

Counterpart of ``orb_slam3_study_kr_tpu/parallel/multihost.py``.  Each
process joins one process group (``initialize``), and the mesh of
``global_mesh`` spans every process: its local shards, then the group for
the others.  ``parallel/dist_ba.py`` runs unchanged; its reductions cross
the process boundaries as ``all_reduce`` calls.

The backend is the caller's choice and never changes on its own: "nccl"
for one card per rank; "gloo" for the CPU and for several ranks on one
card (NCCL refuses two ranks on the same card).  gloo takes CUDA tensors
by staging them through host memory.

Data model: the solver's inputs are host-replicated numpy (every process
builds the same problem); ``put_global`` gives each process its own
shards' rows, ``fetch_replicated`` reads a replicated output and
``gather_sharded`` all-gathers a sharded one to every process.
"""

import numpy as np
import torch
import torch.distributed as dist

from orb_slam3_study_kr_tpu_torch.parallel.dist_ba import make_ba_mesh

BACKENDS = ("gloo", "nccl")


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str) -> None:
    """Join the process group over TCP ("host:port" of process 0)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def global_mesh(devices):
    """The mesh of every process: this process's local shards on
    ``devices``, the world group for the others' (none when the process
    group is not initialized)."""
    return make_ba_mesh(devices, group=dist.group.WORLD
                        if dist.is_initialized() else None)


def put_global(arr, mesh, sharded: bool):
    """Host-replicated numpy -> this process's part on the mesh's first
    local device: the rows of its own shards when ``sharded``, else the
    whole array."""
    arr = np.asarray(arr)
    if sharded:
        arr = mesh.local_rows(arr)
    return torch.as_tensor(np.ascontiguousarray(arr), device=mesh.devices[0])


def fetch_replicated(x) -> np.ndarray:
    """Read a replicated output from the local process."""
    return x.detach().cpu().numpy()


def gather_sharded(x, mesh) -> np.ndarray:
    """Every shard's rows of a sharded output, on every process."""
    return mesh.gather(x)
