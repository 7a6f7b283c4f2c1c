"""Device meshes for sharded corpus serving (port of ``repro.launch.mesh``).

A mesh is a named grid of ``torch.device``s, the port's counterpart of
``jax.sharding.Mesh``: one Python process drives every device of it, as
one JAX controller drives every shard of a ``shard_map``.  A device may
repeat in a mesh -- ``("cpu", "cpu")`` in the CPU tests, ``("cuda:0",) *
2`` on a one-card machine -- which stands in for JAX's forced host devices
(``--xla_force_host_platform_device_count``).

:func:`register_world_axis` names the default ``torch.distributed``
process group as a replica axis, for the one op whose JAX program really
runs once per replica (``optim.compression.compressed_update``'s
``pmean``).  The production pod mesh (``make_production_mesh``) is not
ported: it waits for the LM substrate that consumes it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import register_axis


def _grid_shape(devices) -> Tuple[int, ...]:
    if isinstance(devices, torch.device):
        return ()
    sub = {_grid_shape(d) for d in devices}
    if len(sub) != 1:
        raise ValueError("mesh devices must form a rectangular grid")
    return (len(devices),) + sub.pop()


@dataclasses.dataclass(frozen=True)
class CorpusMesh:
    """A named grid of devices: ``devices`` nests one tuple level per name
    of ``axis_names``.  ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does."""

    axis_names: Tuple[str, ...]
    devices: tuple

    def __post_init__(self):
        dims = _grid_shape(self.devices)
        if len(dims) != len(self.axis_names) or 0 in dims:
            raise ValueError(f"devices of grid shape {dims} do not fit axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, _grid_shape(self.devices)))

    def axis_devices(self, axis: str) -> Tuple[torch.device, ...]:
        """The devices along ``axis`` at index 0 of every other axis: shard
        ``s`` of a tensor split over ``axis`` lives on the ``s``-th (the
        other axes replicate it)."""
        k = self.axis_names.index(axis)
        out = []
        for i in range(self.shape[axis]):
            d = self.devices
            for j in range(len(self.axis_names)):
                d = d[i if j == k else 0]
            out.append(d)
        return tuple(out)


def _device(d) -> torch.device:
    """``d`` as the device its tensors report: ``"cuda"`` is the current
    card's index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _devices(devices: Optional[Sequence]) -> Tuple[torch.device, ...]:
    """``devices`` as ``torch.device``s; by default one a visible card,
    raising when there is none (a mesh never falls back to the CPU)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device is visible; pass devices= "
                               "(e.g. ('cpu', 'cpu')) for a CPU mesh")
        return tuple(torch.device("cuda", i) for i in range(n))
    return tuple(_device(d) for d in devices)


def make_corpus_mesh(data: int = 0, devices: Optional[Sequence] = None
                     ) -> CorpusMesh:
    """1-D ``("data",)`` mesh for sharded corpus-query execution: the
    store shards its corpus rows over this axis (logical axis ``"corpus"``
    in ``distributed.sharding.DEFAULT_RULES``).  ``data=0`` takes every
    device given, by default one a visible card."""
    devs = _devices(devices)
    n = int(data) or len(devs)
    if n > len(devs):
        raise ValueError(f"a data axis of {n} needs {n} devices; "
                         f"{len(devs)} given")
    return CorpusMesh(("data",), devs[:n])


def make_host_mesh(data: int = 1, model: int = 1,
                   devices: Optional[Sequence] = None) -> CorpusMesh:
    """Small ``("data", "model")`` mesh over the devices there are: when
    ``data * model`` exceeds them, every device on the data axis."""
    devs = _devices(devices)
    if data * model > len(devs):
        data, model = len(devs), 1
    return CorpusMesh(("data", "model"), tuple(
        devs[i * model:(i + 1) * model] for i in range(data)))


def register_world_axis(name: str = "data") -> None:
    """Name the default process group (after the caller's
    ``torch.distributed.init_process_group``) as replica axis ``name``, so
    ``compressed_update(axis_name=name)`` all-reduces over it."""
    if not torch.distributed.is_initialized():
        raise RuntimeError("call torch.distributed.init_process_group "
                           "before registering a replica axis")
    register_axis(name, torch.distributed.group.WORLD)
