"""Logical-axis rules and row sharding for the sharded corpus (port of the
corpus half of ``repro.distributed.sharding``).

:data:`DEFAULT_RULES` is a copy of the JAX rule table (held equal to it by
value in the tests); :func:`corpus_axis` resolves the mesh axis that
carries the sketch store's rows.  A sharded corpus buffer is a tuple of
per-shard tensors, shard ``s`` holding one contiguous row range on the
mesh's ``s``-th device along that axis: :func:`shard_rows` makes one from
a tensor and :func:`gather_rows` puts one back together.

Replica axes: the JAX package's ``pmean(x, axis_name)`` runs inside a
program that runs once per replica.  The port's counterpart is a
``torch.distributed`` process group, registered under the axis name with
:func:`register_axis` (``launch.mesh.register_world_axis`` names the
default group) and looked up by :func:`axis_group`.

The model-side rules (``spec_for``, ``rules_for_cell``, ``ShardingCtx``
and the rest) wait for the LM substrate that uses them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

MeshAxes = Union[None, str, Tuple[str, ...]]

# the JAX package's production rules for the (pod, data, model) mesh
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "fsdp": ("pod", "data"),
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": "model",
    "tokens": ("pod", "data"),
    "capacity": ("pod", "data"),
    "layers": None,
    "groups": None,
    "cache_seq": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
    "dt_rank": None,
    "stats": None,
    "corpus": "data",             # sketch-store corpus rows: queries
                                  # replicate, corpus rows shard
}


def corpus_axis(mesh, rules: Optional[Dict[str, MeshAxes]] = None
                ) -> Optional[str]:
    """The mesh axis carrying the logical ``"corpus"`` (store row) dim, or
    ``None`` when the mesh is absent, the name unmapped or every mapped
    axis of size 1: then the single-launch path runs."""
    if mesh is None:
        return None
    mapped = (rules or DEFAULT_RULES).get("corpus")
    if mapped is None:
        return None
    axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
    for a in axes:
        if mesh.shape.get(a, 1) > 1:
            return a
    return None


def axis_size(mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape.get(a, 1)
    return size


def make_rules(**overrides) -> Dict[str, MeshAxes]:
    rules = dict(DEFAULT_RULES)
    rules.update(overrides)
    return rules


def shard_rows(x: torch.Tensor, devices: Sequence[torch.device], *,
               fill=0, dim: int = 1, rows: Optional[int] = None
               ) -> Tuple[torch.Tensor, ...]:
    """``x`` split along ``dim`` into ``len(devices)`` equal contiguous row
    ranges, shard ``s`` on ``devices[s]``: first padded at the end with
    ``fill`` to ``rows`` rows (default: the next multiple of the shard
    count), so spare rows hold the family's inert fill."""
    d = len(devices)
    n = x.shape[dim]
    rows = n + (-n) % d if rows is None else int(rows)
    if rows % d or rows < n:
        raise ValueError(f"{rows} rows do not split over {d} shards of "
                         f"{n} rows")
    if rows > n:
        pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, rows - n]
        x = F.pad(x, pad, value=fill)
    return tuple(p.to(dev).contiguous()
                 for p, dev in zip(x.split(rows // d, dim), devices))


def gather_rows(parts: Sequence[torch.Tensor], device, *, dim: int = 1
                ) -> torch.Tensor:
    """Per-shard row ranges back into one tensor on ``device``, in shard
    order (one shard: the tensor itself)."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)


_REPLICA_GROUPS: Dict[str, object] = {}


def register_axis(name: str, group) -> None:
    """Name a ``torch.distributed`` process group as a replica axis."""
    _REPLICA_GROUPS[str(name)] = group


def axis_group(name: str):
    """The process group registered under ``name``; raises when there is
    none or ``torch.distributed`` is not initialised, so a named axis never
    runs as one replica by accident."""
    if not torch.distributed.is_initialized():
        raise RuntimeError(f"replica axis {name!r}: torch.distributed is not "
                           "initialised")
    try:
        return _REPLICA_GROUPS[str(name)]
    except KeyError:
        raise ValueError(f"no process group registered for replica axis "
                         f"{name!r}; have {sorted(_REPLICA_GROUPS)}") from None
