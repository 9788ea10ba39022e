"""Multi-process initialization and the meshes over all ranks.

Counterpart of ``bndm_tpu/parallel/distributed.py``. JAX starts its job with
``jax.distributed.initialize`` and builds one Mesh over every device; here
one process drives one device, ``torch.distributed.init_process_group``
joins the processes, and a ``DeviceMesh`` names the ranks. Each rank feeds
its own rows of the global batch
(``BatchLoader(shard_index=index, shard_count=count)``).

A GPU has no TPU ``slice_index``: the 2-D hybrid mesh groups ranks by host
instead (NVLink inside a host, the network across hosts), from the
hostnames the ranks exchange.
"""

from __future__ import annotations

import atexit
import socket

import torch
import torch.distributed as dist


def _backend_for(device, backend):
    if backend is not None:
        return backend
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address=None, num_processes=None, process_id=None, *,
                     device="cuda", backend=None):
    """Idempotent ``init_process_group``; a no-op for a single process with
    no coordinator, as in JAX. ``coordinator_address`` is ``host:port`` of
    rank 0. The backend is NCCL on CUDA and gloo on the CPU unless
    ``backend`` names one (gloo lets several ranks share one card, which
    NCCL refuses). On CUDA each rank takes ``cuda:{rank % device_count}``.
    Returns the rank's device."""
    device = torch.device(device)
    if dist.is_initialized():
        return _rank_device(device, dist.get_rank())
    if coordinator_address is None and num_processes in (None, 1):
        return device  # single process, nothing to do
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs --coordinator_address, "
                         "--num_processes and --process_id")
    rank_device = _rank_device(device, process_id)
    if rank_device.type == "cuda":
        torch.cuda.set_device(rank_device)
    dist.init_process_group(_backend_for(device, backend),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    # leave the group before the interpreter exits: a gloo group still
    # alive at exit can abort the process ("terminate called without an
    # active exception") after its work is done
    atexit.register(shutdown)
    return rank_device


def _rank_device(device, rank):
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def shutdown():
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier():
    """Wait for every rank (nothing to wait for without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def host_shard_info():
    """(rank, world size) for per-rank data loading; (0, 1) alone."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def mesh_device_type():
    """The DeviceMesh device type of the joined backend: CUDA under NCCL,
    the CPU under gloo (whose collectives also take CUDA tensors)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def global_mesh(axis_name="data"):
    """1-D mesh over every rank of the job."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(mesh_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def groups_by_host(hosts):
    """Group ranks by host: ``hosts[r]`` is rank r's hostname. Returns the
    rank groups in order of their lowest rank, or None for one host or
    ragged hosts (the caller then splits the ranks evenly), as
    ``_devices_by_slice`` does with TPU slices."""
    groups = {}
    for rank, host in enumerate(hosts):
        groups.setdefault(host, []).append(rank)
    if len(groups) <= 1 or len({len(g) for g in groups.values()}) != 1:
        return None
    return sorted(groups.values(), key=lambda g: g[0])


def hybrid_layout(world, num_slices=None, groups=None):
    """The rank array (replica, data) of the hybrid mesh, JAX's
    ``hybrid_mesh`` rules on ranks: ``groups`` win (equal sizes required);
    else ``num_slices`` splits ``range(world)`` evenly (it must divide
    it)."""
    if groups is not None:
        if len({len(g) for g in groups}) != 1:
            raise ValueError("groups must be equally sized")
        return [list(g) for g in groups]
    num_slices = num_slices or 1
    if world % num_slices:
        raise ValueError(f"{world} devices do not split into {num_slices} slices")
    per = world // num_slices
    return [list(range(i * per, (i + 1) * per)) for i in range(num_slices)]


def host_groups():
    """The ranks grouped by host (:func:`groups_by_host` of every rank's
    hostname), None on one host."""
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    return groups_by_host(hosts)


def hybrid_mesh(num_slices=None, dcn_axis="replica", ici_axis="data", groups=None):
    """2-D (replica, data) mesh: replicas across hosts, data within a host.

    Ranks group by host (:func:`host_groups`) unless ``groups`` is given; on
    one host ``num_slices`` splits the ranks evenly, which keeps the
    collective layout of a multi-host job (what the tests check). Data
    parallelism shards the batch over both axes and reduces the gradient
    over all ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    if groups is None:
        found = host_groups()
        if found is not None and num_slices is not None and num_slices != len(found):
            raise ValueError(f"num_slices={num_slices} but topology reports "
                             f"{len(found)} slices")
        groups = found
    layout = hybrid_layout(dist.get_world_size(), num_slices, groups)
    return DeviceMesh(mesh_device_type(), torch.tensor(layout),
                      mesh_dim_names=(dcn_axis, ici_axis))
