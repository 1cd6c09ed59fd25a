"""Mesh construction as `init_device_mesh` builders; a port of
`repro/launch/mesh.py`.

Defined as functions (never module-level meshes): a mesh needs the
default process group, which the caller starts (`init_process_group`
with its address, world size and rank), and importing this module
touches no device and no group.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production shapes: 16×16, or 2×16×16 for two pods.

    Axes: 'pod' is the outer data axis across the slow link; 'data' hosts
    FSDP/EP/DP; 'model' hosts tensor parallelism.  The world must hold
    256 (512) ranks, real or of a fake process group.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_mesh_for_devices(n_devices: int, model_parallel: int = 1,
                          axes: tuple[str, str] = ("data", "model"),
                          device_type: str = "cuda") -> DeviceMesh:
    """Largest (data, model) grid for an elastic restart (repro_torch.ft)
    over a world of `n_devices` ranks."""
    model = min(model_parallel, n_devices)
    while n_devices % model:
        model -= 1
    return init_device_mesh(device_type, (n_devices // model, model),
                            mesh_dim_names=axes)
