"""Production and debug meshes, the twin of ``repro.launch.mesh``.

Single pod: 16 x 16 = 256 cards, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 cards, axes ("pod", "data", "model"); the
"pod" axis is pure data parallelism across pods.

The shapes are the JAX package's, so the policies' specs stay comparable.
Functions only: importing this module touches no process group.
``fake_world`` starts the one-process fake process group that stands in
for 256 or 512 ranks in the dry run.
"""
from __future__ import annotations

import contextlib

from ..runtime.sharding import AbstractMesh


def production_shape(*, multi_pod: bool = False) -> tuple[tuple, tuple]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's names and sizes, no devices (for policies)."""
    shape, axes = production_shape(multi_pod=multi_pod)
    return AbstractMesh(axes, shape)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """The production ``DeviceMesh`` over the default process group, which
    must have 256 (512) ranks: the fake group of ``fake_world`` in the dry
    run, or a real one."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = production_shape(multi_pod=multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(n_devices: int | None = None, device_type: str = "cpu"):
    """A small ("data", "model") mesh over the ranks of the default process
    group (the JAX rule: the largest of 4, 2, 1 that divides them on
    "model")."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = n_devices or dist.get_world_size()
    model = next(c for c in (4, 2, 1) if n % c == 0)
    return init_device_mesh(device_type, (n // model, model), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake process group of ``n_ranks`` in this one process (rank 0):
    collectives return at once and move nothing. Destroyed on exit, so that
    nothing after it sees the group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the dry run needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()
