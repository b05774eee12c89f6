"""Production and debug meshes: the port's copy of
``repro.launch.mesh``.

Each is a ``torch.distributed`` ``DeviceMesh`` over the default process
group, built by a function (never a module constant), so importing this
module touches no process group.  The caller starts the group first
(``init_process_group`` with its own address, size and rank; the dry run
uses a fake group); a group of another size than the mesh raises.
"""
from __future__ import annotations


def _mesh(shape, axes, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("start torch.distributed (init_process_group) "
                           "before building a mesh")
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size()
    if have != n:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks, "
                         f"the process group has {have}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod: (pod=2, data=16, model=16) = 512 ranks; the ``pod`` axis
    is pure data parallelism across pods."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, *,
                    multi_pod: bool = False, n_pods: int = 2,
                    device_type: str = "cuda"):
    """Small mesh for tests and the one-card check: (data, model), or
    (pod, data, model) with ``n_pods`` pods."""
    if multi_pod:
        return _mesh((n_pods, n_data, n_model), ("pod", "data", "model"),
                     device_type)
    return _mesh((n_data, n_model), ("data", "model"), device_type)
