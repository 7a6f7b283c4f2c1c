"""Carry a served corpus across from the JAX package (the system's
counterpart of loading weights).

A JAX ``DatasetSearchIndex``'s state is its store buffers, row count and
tenant ranges plus, per table, the name, row count and KMV sample.  The
caller exports them as numpy (this module imports nothing of JAX)::

    buffers = [np.asarray(b) for b in jax_index.store.buffers()]
    tables = [(t.name, t.n_rows, (t.sample.hashes, t.sample.values))
              for t in jax_index.tables]
    ranges = {t: jax_index.store.tenant_ranges(t)
              for t in jax_index.store.tenants()}
    index = index_from_numpy(buffers, len(jax_index.store), tables=tables,
                             tenant_ranges=ranges, m=jax_index.m,
                             seed=jax_index.seed,
                             family=jax_index.family.name, device="cuda")

and gets a port index that serves the same sketch rows (the export holds
no host oracle sketches, so the index keeps none).  All six families
are carried, one buffer per component of the family: ICWS and DMH share
the ICWS buffers, CS and JL carry their tables, TS and PS their sample
keys, values and taus.  A packed JAX index (``packed=True``) carries its
packed buffers (``family.packed_components``), written as they are.

A JAX ``SketchCorpus`` is carried the same way, from its exact-size rows::

    corpus = corpus_from_numpy(*[np.asarray(a) for a in jax_corpus.arrays()],
                               m=jax_corpus.m, seed=jax_corpus.seed,
                               device="cuda")

A JAX ``Model``'s parameters of the dense, moe or vlm family
(``Model(cfg).init(key)[0]``, each layer's stacked on a leading ``[L,
...]`` axis) carry across as they are::

    tree = jax.tree.map(np.asarray, jax_params)
    params = model_params_from_numpy(repro_torch.configs.get(name), tree,
                                     device="cuda")

and the port's ``Model`` of the same config computes with them what the
JAX model computes.  JAX's AdamW state (``{"mu", "nu", "step"}``, bf16
moments) carries across beside them with ``opt_state_from_numpy``, so a
run JAX started continues in the port (a checkpoint of either package
also restores in the other: ``repro_torch.checkpoint``).  ``model_params_to(params, "cpu")`` moves a port
parameter tree to another device (the card's weights to the CPU's plain
run, say).

Gradient compression and flash attention carry no state to convert: the
compression's only state is the flat error-feedback residual, which passes
as a tensor (``torch.from_numpy(np.asarray(residual))``), and attention has
no parameters.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import KMVSketch
from repro_torch.data.corpus import SketchCorpus
from repro_torch.data.dataset_search import DatasetSearchIndex
from repro_torch.device import resolve_device


def corpus_from_numpy(fp: np.ndarray, val: np.ndarray, norm: np.ndarray,
                      argkey: np.ndarray, *, m: int, seed: int = 0,
                      mesh=None, device="cuda") -> SketchCorpus:
    """A port corpus over the given sketch rows (``fp``, ``val``,
    ``argkey`` ``[P, m]``, ``norm`` ``[P]``), queried with the JAX corpus's
    ``m`` and ``seed``, its rows sharded over ``mesh``'s corpus axis if it
    has one; the store validates the rows."""
    corpus = SketchCorpus(m=m, seed=seed, mesh=mesh, device=device)
    corpus.add_sketches(*(np.array(a) for a in (fp, val, norm, argkey)))
    return corpus


def index_from_numpy(buffers: Sequence[np.ndarray], size: int, *,
                     tables: Sequence[Tuple[str, int,
                                            Tuple[np.ndarray, np.ndarray]]],
                     tenant_ranges: Optional[Dict[str, Sequence[
                         Tuple[int, int]]]] = None,
                     m: int, seed: int = 0, key_space: int = 2 ** 31,
                     family: str = "icws", packed: bool = False,
                     mesh=None, device="cuda") -> DatasetSearchIndex:
    """A port index over the given corpus.

    Args:
      buffers: a JAX store's ``buffers()`` as numpy, one per component of
        the family: icws and dmh ``(fp [3, cap, m], val [3, cap, m], norm
        [3, cap], argkey [3, cap, m])``; cs and jl ``(tables [3, cap, R,
        W],)``; ts and ps ``(keys [3, cap, S], values [3, cap, S], taus
        [3, cap])``; with ``packed``, the family's packed components.
      size: live rows per field (the first ``size`` rows are copied).
      tables: per table ``(name, n_rows, (kmv_hashes, kmv_values))``, in
        store-row order (table i is row i).
      tenant_ranges: tenant id -> its ``[start, stop)`` row ranges.
      m, seed, key_space, family, packed: the JAX index's parameters
        (queries sketch with them, so they must match the corpus).
      mesh: shards the port index's rows over its corpus axis.
    """
    if len(tables) != size:
        raise ValueError(f"{len(tables)} tables for {size} store rows")
    index = DatasetSearchIndex(m=m, seed=seed, key_space=key_space,
                               keep_host_oracle=False, family=family,
                               packed=packed, mesh=mesh, device=device)
    if size == 0:
        return index
    specs = (index.family.packed_components if packed
             else index.family.components)
    append = index.store.append_packed if packed else index.store.append
    if len(buffers) != len(specs):
        raise ValueError(f"{family} corpus has {len(specs)} buffers "
                         f"({', '.join(s.name for s in specs)}); got "
                         f"{len(buffers)}")
    bufs = [np.array(b) for b in buffers]
    for b, spec in zip(bufs, specs):
        if tuple(b.shape[2:]) != spec.trailing:
            raise ValueError(f"corpus {spec.name} rows have shape "
                             f"{tuple(b.shape[2:])}; the {family} index "
                             f"(m={m}) needs {spec.trailing}")
    owner: Dict[int, str] = {}
    for tenant, ranges in (tenant_ranges or {}).items():
        for lo, hi in ranges:
            owner.update((r, str(tenant)) for r in range(lo, hi))
    # append run by run of rows sharing an owner, so the store records the
    # same coalesced tenant ranges
    lo = 0
    while lo < size:
        hi = lo + 1
        while hi < size and owner.get(hi) == owner.get(lo):
            hi += 1
        append(*(b[:, lo:hi] for b in bufs), tenant=owner.get(lo))
        lo = hi
    for row, (name, n_rows, (hashes, values)) in enumerate(tables):
        sample = KMVSketch(hashes=np.asarray(hashes, np.int64),
                           values=np.asarray(values, np.float64),
                           k=index.kmv.k, seed=index.kmv.seed)
        index._register_table(name, int(n_rows), sample,
                              tenant=owner.get(row))
    return index


def _param_shapes(cfg):
    """The model's parameter tree (the dense, moe and vlm families), as
    leaf shapes."""
    L, d, V, F = cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.d_ff
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    layers = {"attn": {"wq": (L, d, H, hd), "wk": (L, d, K, hd),
                       "wv": (L, d, K, hd), "wo": (L, H, hd, d)},
              "norm1": (L, d), "norm2": (L, d)}
    if cfg.num_experts and cfg.moe_every == 1:
        E = cfg.num_experts
        layers["moe"] = {"w_router": (L, d, E), "w_gate": (L, E, d, F),
                         "w_up": (L, E, d, F), "w_down": (L, E, F, d)}
    else:
        layers["mlp"] = {"w_up": (L, d, F), "w_down": (L, F, d)}
        if cfg.mlp_variant in ("swiglu", "geglu"):
            layers["mlp"]["w_gate"] = (L, d, F)
    shapes = {"embed": (V, d), "final_norm": (d,), "layers": layers}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, V)
    if cfg.family == "vlm":
        shapes["patch_proj"] = (d, d)
    return shapes


def _carry(cfg, want, got, path, dev, dtype=torch.float32):
    """``got`` (a numpy tree) as tensors of ``dtype`` on ``dev``, checked
    against the shape tree ``want``."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            keys = sorted(got) if isinstance(got, dict) else type(got)
            raise ValueError(f"{path or 'params'}: keys {keys}; "
                             f"{cfg.name} needs {sorted(want)}")
        return {k: _carry(cfg, w, got[k], f"{path}/{k}", dev, dtype)
                for k, w in want.items()}
    a = np.asarray(got, np.float32)
    if a.shape != want:
        raise ValueError(f"{path}: shape {a.shape}; {cfg.name} needs "
                         f"{want}")
    return torch.from_numpy(a.copy()).to(dev).to(dtype)


def model_params_from_numpy(cfg, tree, device="cuda"):
    """The port's parameters of the model ``cfg`` from a JAX
    parameter tree exported as numpy: the same tree of f32 tensors on
    ``device``.  Raises ``ValueError`` where a key or a shape differs from
    what ``cfg`` needs."""
    return _carry(cfg, _param_shapes(cfg), tree, "", resolve_device(device))


def opt_state_from_numpy(cfg, tree, moment_dtype: str = "bfloat16",
                         device="cuda"):
    """The port's AdamW state of the model ``cfg`` from JAX's
    ``{"mu", "nu", "step"}`` exported as numpy (``jax.tree.map(np.asarray,
    opt_state)``; bf16 moments arrive as ``ml_dtypes`` arrays, which
    widen to f32 exactly): moments of ``moment_dtype`` and ``step`` a 0-d
    int32 tensor, on ``device``."""
    dev = resolve_device(device)
    if not isinstance(tree, dict) or set(tree) != {"mu", "nu", "step"}:
        raise ValueError("opt_state needs the keys ['mu', 'nu', 'step']")
    shapes, dt = _param_shapes(cfg), getattr(torch, moment_dtype)
    return {"mu": _carry(cfg, shapes, tree["mu"], "mu", dev, dt),
            "nu": _carry(cfg, shapes, tree["nu"], "nu", dev, dt),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=dev)}


def model_params_to(tree, device):
    """The port's parameter tree ``tree`` with every tensor on ``device``."""
    dev = resolve_device(device)
    return {k: model_params_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}
