"""Device meshes and data parallelism over ranks.

Counterpart of ``bndm_tpu/parallel/mesh.py``. JAX shards a global batch
over a Mesh and lets XLA insert the gradient all-reduce; here each rank
(one process, one device) holds its block of rows of the global batch,
rank r's block being rows ``[p * B/P, (p+1) * B/P)`` for its position p in
the mesh (the layout JAX's ``shard_host_local_batch`` builds from
per-process rows), and ``DistributedDataParallel`` sums the gradient over
the ranks. A rank's loader reads that block itself
(``BatchLoader(shard_index=p, shard_count=P)``), so the port needs neither
``shard_host_local_batch`` nor ``data_parallel_sharding``'s placements;
:func:`~bndm_tpu_torch.parallel.distributed.global_mesh` builds the 1-D
mesh ``make_mesh`` would.

The train steps compute each rank's share of the global loss (a sum over
its rows, or its rows' part of a mean), so the summed gradient is the global
batch's, the single-device step's of JAX. A mesh is ``None`` for a run of
one process without a process group: every helper then leaves the batch
and the state as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from bndm_tpu_torch.parallel.distributed import host_groups, hybrid_layout, mesh_device_type


def auto_layout(batch_size, world, groups=None):
    """The rank layout :func:`auto_mesh` builds: the (replica, data) array
    of the host ``groups`` (None: one host), else the 1-D ``range(world)``.

    JAX's ``auto_mesh`` shrinks the device count until it divides the
    batch; a torch job's world is fixed when its processes start (one
    process, one device), so a batch that does not divide across the ranks
    raises instead, with the JAX CLIs' message."""
    if batch_size % world:
        raise ValueError(f"--batch_size={batch_size} must divide across {world} processes")
    if groups is not None:
        return hybrid_layout(world, groups=groups)
    return list(range(world))


def auto_mesh(batch_size, axis_name="data"):
    """Mesh over every rank for a global batch of ``batch_size`` rows: the
    hybrid (replica, data) mesh when the ranks span several hosts, else 1-D
    (see :func:`auto_layout`; raises when the batch does not divide)."""
    from torch.distributed.device_mesh import DeviceMesh

    groups = host_groups()
    layout = auto_layout(batch_size, dist.get_world_size(), groups)
    names = ("replica", "data") if groups is not None else (axis_name,)
    return DeviceMesh(mesh_device_type(), torch.tensor(layout), mesh_dim_names=names)


def run_mesh(batch_size=None):
    """The mesh of a run: :func:`auto_mesh` for ``batch_size`` rows (any
    count when None) once a process group is joined, else None (one
    process)."""
    if not dist.is_initialized():
        return None
    return auto_mesh(batch_size or dist.get_world_size())


def data_shard(mesh):
    """(position, count): this rank's block of the batch, in mesh order
    (row-major over every axis); (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    pos = 0
    for axis, c in enumerate(mesh.get_coordinate()):
        pos = pos * mesh.size(axis) + c
    return pos, mesh.size()


def block_rows(mesh, n):
    """The slice of this rank's rows of a global batch of ``n`` rows;
    raises when ``n`` does not divide across the ranks."""
    pos, count = data_shard(mesh)
    if n % count:
        raise ValueError(f"a batch of {n} rows does not divide across {count} processes")
    b = n // count
    return slice(pos * b, (pos + 1) * b)


def local_rows(mesh, *tensors):
    """This rank's block of rows of each global-batch tensor (a tuple);
    the tensors themselves, untouched, without a mesh."""
    if mesh is None:
        return tensors
    rows = block_rows(mesh, tensors[0].shape[0])
    return tuple(t[rows] for t in tensors)


def shard_batch(mesh, batch):
    """This rank's block of rows of the global ``batch`` (every rank holds
    the whole batch, e.g. drawn from a shared seed)."""
    return batch[block_rows(mesh, batch.shape[0])]


def gather_batch(mesh, local):
    """Every rank's block, concatenated in mesh order: the global batch
    (on every rank; rank 0 writes it)."""
    if mesh is None:
        return local
    parts = [torch.empty_like(local) for _ in range(mesh.size())]
    dist.all_gather(parts, local.contiguous(), group=_group(mesh))
    order = [None] * mesh.size()
    ranks = mesh.mesh.flatten().tolist()
    for pos, rank in enumerate(ranks):
        order[pos] = parts[_group_rank(mesh, rank)]
    return torch.cat(order)


def _group(mesh):
    """The process group over every rank of the mesh."""
    if mesh.ndim == 1:
        return mesh.get_group(0)
    if mesh.size() != dist.get_world_size():
        raise ValueError("a 2-D mesh must span every rank")
    return dist.group.WORLD


def _group_rank(mesh, rank):
    return dist.get_group_rank(_group(mesh), rank)


def all_reduce_sum_(mesh, tensors):
    """Sum each tensor over the mesh's ranks in place (nothing to do
    without a mesh)."""
    if mesh is None:
        return
    for t in tensors:
        dist.all_reduce(t, group=_group(mesh))


def _sum_hook(group, bucket):
    """DDP communication hook: the bucket's gradients summed over the ranks
    (DDP's own hook averages them; the losses here are each rank's share of
    the global loss, so their gradients add)."""
    fut = dist.all_reduce(bucket.buffer(), group=group, async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


def wrap_ddp(model, mesh):
    """``model`` in ``DistributedDataParallel`` over the mesh's ranks, its
    gradients summed (:func:`_sum_hook`); the model itself when there is
    no mesh."""
    if mesh is None:
        return model
    from torch.nn.parallel import DistributedDataParallel

    dev = next(model.parameters()).device
    group = _group(mesh)
    ddp = DistributedDataParallel(model, device_ids=[dev] if dev.type == "cuda" else None,
                                  process_group=group)
    ddp.register_comm_hook(group, _sum_hook)
    return ddp


def _tensors_and_rest(tree, tensors, rest):
    """Split a state_dict tree: its tensors in order into ``tensors``, its
    other leaves into ``rest``; returns the tree's skeleton."""
    if isinstance(tree, torch.Tensor):
        tensors.append(tree)
        return ("T", len(tensors) - 1)
    if isinstance(tree, dict):
        return {k: _tensors_and_rest(v, tensors, rest) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors_and_rest(v, tensors, rest) for v in tree)
    rest.append(tree)
    return ("R", len(rest) - 1)


def _rebuild(skel, tensors, rest):
    if isinstance(skel, dict):
        return {k: _rebuild(v, tensors, rest) for k, v in skel.items()}
    if isinstance(skel, tuple) and len(skel) == 2 and skel[0] in ("T", "R"):
        return tensors[skel[1]] if skel[0] == "T" else rest[skel[1]]
    return type(skel)(_rebuild(v, tensors, rest) for v in skel)


def replicate(mesh, obj):
    """Broadcast rank 0's values of ``obj`` to every rank, in place, and
    return it: a module's parameters and buffers, or a whole train state
    (anything with ``state_dict``/``load_state_dict``: the weights, both
    optimizers' states, the schedule parameters, the EMA, the accumulation
    buffers and the step counts)."""
    if mesh is None:
        return obj
    group = _group(mesh)
    src = dist.get_global_rank(group, 0)
    comm = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else None

    def bcast(t):
        buf = t.detach() if comm is None or t.device == comm else t.detach().to(comm)
        dist.broadcast(buf, src=src, group=group)
        if buf is not t:
            with torch.no_grad():
                t.copy_(buf)

    if isinstance(obj, torch.nn.Module):
        for t in list(obj.parameters()) + list(obj.buffers()):
            bcast(t)
        return obj
    tensors, rest = [], []
    skel = _tensors_and_rest(obj.state_dict(), tensors, rest)
    for t in tensors:
        bcast(t)
    box = [rest]
    dist.broadcast_object_list(box, src=src, group=group)
    obj.load_state_dict(_rebuild(skel, tensors, box[0]))
    return obj

