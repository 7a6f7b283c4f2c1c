"""The transformer stack in PyTorch: the port of
``repro/models/transformer.py::Model`` for the families JAX runs on one
block stack (``family`` dense, moe and vlm).

Parameters are a tree of f32 tensors shaped as the JAX package's, each
layer's stacked on a leading ``[L, ...]`` axis (``convert.
model_params_from_numpy`` carries a JAX tree across as it is); the layers
run in a Python loop over that axis.  ``forward`` and ``loss`` record for
autograd when grad is enabled, each block under
``torch.utils.checkpoint`` (the counterpart of JAX's ``jax.checkpoint``:
its activations are recomputed in the backward, always); ``init`` runs
under ``torch.no_grad()`` (its tensors can take ``requires_grad``) and the
decode path under ``torch.inference_mode()``.  The decode state's KV cache
is ``[L, B, S, K, hd]`` bf16, written in place by ``decode_step``.  A
moe block's FFN is ``models/moe.py``'s (every layer's, as JAX's stack); a
vlm puts its projected patch embeddings before the tokens, decodes text
only and takes its loss on the text positions.  The other families (ssm,
hybrid, encdec) and the model mesh (``ctx``) are not ported yet
(ROADMAP.md Queue A 18c).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import attention as attn
from . import moe as moe_mod
from .counting import count_params
from .layers import (COMPUTE_DTYPE, PARAM_DTYPE, apply_mlp, cross_entropy,
                     embed, init_embedding, init_mlp, init_normal, lm_logits,
                     rms_norm)


def _stack(trees):
    """One tree of the per-layer trees' leaves stacked on a new axis 0."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _check_tf32(device):
    """The attention products run in f32 (bf16 inputs widened, as JAX's
    ``preferred_element_type``): TF32 would round their inputs to 10
    bits on the card."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is True: "
                           "the model's f32 attention products need it "
                           "False (PyTorch's default)")


def _unbind(layers, n: int):
    """Every layer's parameters, views into the stacked tree, from one
    ``unbind`` a leaf: its backward stacks the L gradients once, where L
    ``select`` backwards would each write a whole ``[L, ...]`` tensor."""
    parts = {k: _unbind(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in layers.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


FAMILIES = ("dense", "moe", "vlm")


def check_fits(cfg, free_bytes: int):
    """Raises ``MemoryError`` where ``cfg``'s f32 parameters take more
    than ``free_bytes``."""
    need = 4 * count_params(cfg)
    if need > free_bytes:
        raise MemoryError(
            f"{cfg.name} ({cfg.num_layers} layers): {need:,} bytes of f32 "
            f"parameters exceed the {free_bytes:,} bytes free on the device")


class Model:
    def __init__(self, cfg, device="cuda"):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet: the "
                f"port's Model runs the families {', '.join(FAMILIES)} "
                "(ROADMAP.md Queue A 18c)")
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """f32 parameters drawn from ``generator``, which must lie on the
        model's device.  On the card, raises ``MemoryError`` before it
        allocates where they would not fit in the free memory."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        if self.device.type == "cuda":
            # the blocks this process's allocator holds but no tensor uses
            # are free to it, though not to cudaMemGetInfo's count
            cached = (torch.cuda.memory_reserved(self.device)
                      - torch.cuda.memory_allocated(self.device))
            check_fits(cfg, torch.cuda.mem_get_info(self.device)[0] + cached)
        params: Dict[str, Any] = {
            "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model)}
        if not cfg.tie_embeddings:
            params["lm_head"] = init_normal(
                generator, (cfg.d_model, cfg.vocab_size),
                1.0 / math.sqrt(cfg.d_model))
        params["final_norm"] = torch.zeros(cfg.d_model, dtype=PARAM_DTYPE,
                                           device=self.device)
        params["layers"] = _stack([self._init_block(generator)
                                   for _ in range(cfg.num_layers)])
        if cfg.family == "vlm":
            params["patch_proj"] = init_normal(
                generator, (cfg.d_model, cfg.d_model),
                1.0 / math.sqrt(cfg.d_model))
        return params

    def _init_block(self, generator):
        cfg = self.cfg
        zeros = torch.zeros(cfg.d_model, dtype=PARAM_DTYPE,
                            device=self.device)
        block = {"attn": attn.init_attention(generator, cfg),
                 "norm1": zeros, "norm2": zeros.clone()}
        # one homogeneous stack: a MoE FFN in every layer or in none, as
        # JAX's (interleaved MoE is the hybrid family's)
        if cfg.num_experts and cfg.moe_every == 1:
            block["moe"] = moe_mod.init_moe(generator, cfg)
        else:
            block["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff,
                                    cfg.mlp_variant)
        return block

    def _ffn_sublayer(self, layer, x, o):
        """The attention residual ``x + o``, then the FFN sublayer (the MLP,
        or the MoE on the ``[B * T, d]`` tokens).  The sum feeds the norm
        in f32, unrounded, as XLA's compiled JAX program keeps it (excess
        precision), and enters the FFN residual rounded to bf16, as the
        program states it.  Returns the block's output and its
        load-balance loss (None without a MoE)."""
        x = x.float() + o.float()
        h = rms_norm(x, layer["norm2"], self.cfg.norm_eps).to(COMPUTE_DTYPE)
        if "moe" in layer:
            y, aux = moe_mod.moe_ffn(layer["moe"], h.reshape(-1, h.shape[-1]),
                                     self.cfg)
            y = y.view(h.shape)
        else:
            y, aux = apply_mlp(layer["mlp"], h, self.cfg.mlp_variant), None
        return x.to(COMPUTE_DTYPE) + y, aux

    def _head(self, params):
        return params["embed" if self.cfg.tie_embeddings else "lm_head"]

    def _block(self, layer, x, q_chunk: int, k_chunk: int):
        h = rms_norm(x, layer["norm1"], self.cfg.norm_eps)
        o = attn.attention_block(layer["attn"], h, self.cfg, q_chunk=q_chunk,
                                 k_chunk=k_chunk)
        return self._ffn_sublayer(layer, x, o)

    # --------------------------------------------------------------- forward
    def forward(self, params, batch, q_chunk: int = 1024,
                k_chunk: int = 1024):
        """Logits ``[B, T, V]`` (bf16) of ``batch["tokens"]`` ``[B, T]``
        (``[B, P + T, V]`` for a vlm, its ``batch["patches"]`` ``[B, P, d]``
        first), and the auxiliary loss (the MoE layers' load-balance losses
        summed; 0 without them), as JAX's pair.  Each block runs under
        ``checkpoint`` (JAX's ``jax.checkpoint``), which computes the same
        values; with grad disabled it saves nothing."""
        _check_tf32(self.device)
        cfg = self.cfg
        x = embed(params["embed"], batch["tokens"])
        if cfg.family == "vlm":
            patches = (batch["patches"].to(x.dtype)
                       @ params["patch_proj"].to(x.dtype))
            x = torch.cat([patches, x], dim=1)
        auxs = []
        for layer in _unbind(params["layers"], cfg.num_layers):
            # the blocks draw no random numbers: no RNG state to replay
            x, aux = checkpoint(self._block, layer, x, q_chunk, k_chunk,
                                use_reentrant=False, preserve_rng_state=False)
            if aux is not None:
                auxs.append(aux)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        aux = (torch.stack(auxs).sum() if auxs else
               torch.zeros((), dtype=torch.float32, device=x.device))
        return lm_logits(x, self._head(params)), aux

    # ----------------------------------------------------------------- loss
    def loss(self, params, batch, q_chunk: int = 1024, k_chunk: int = 1024,
             aux_weight: float = 0.01):
        """``(ce + aux_weight * aux, {"ce", "aux"})`` of ``batch``'s
        ``tokens`` against its ``labels`` ``[B, T]`` (and ``mask``, where
        it has one), as JAX's ``Model.loss``; a vlm's on the text
        positions only."""
        logits, aux = self.forward(params, batch, q_chunk, k_chunk)
        if self.cfg.family == "vlm":
            logits = logits[:, self.cfg.num_patches:]
        ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}

    # --------------------------------------------------------------- decode
    @torch.inference_mode()
    def init_decode_state(self, batch: int, max_seq: int) -> Dict[str, Any]:
        layout = attn.cache_layout(self.cfg, max_seq)
        self._layout = layout
        return {"pos": torch.zeros((), dtype=torch.int32, device=self.device),
                "kv": attn.init_kv_cache(self.cfg, self.cfg.num_layers, batch,
                                         layout, self.device),
                "slot_pos": torch.full((layout.size,), -1, dtype=torch.int32,
                                       device=self.device)}

    @torch.inference_mode()
    def decode_step(self, params, tokens, state):
        """One token for every batch row: tokens ``[B, 1]`` at the state's
        shared ``pos``.  Returns (logits ``[B, 1, V]``, new state); the new
        state holds ``pos + 1``, the updated ``slot_pos`` and the same cache
        tensors, written in place.  A MoE layer routes the ``[B, d]``
        tokens and drops its load-balance loss; a vlm decodes text only."""
        _check_tf32(self.device)
        cfg = self.cfg
        pos = state["pos"]
        x = embed(params["embed"], tokens)
        layout = getattr(self, "_layout", None)
        if layout is None:
            size = int(state["slot_pos"].shape[0])
            layout = attn.CacheLayout(size=size, windowed=bool(
                cfg.sliding_window) and size == cfg.sliding_window)
        # an out-of-range slot is dropped here, as JAX's ``.at[].set`` drops it
        slot = attn.cache_slot(pos, layout)
        slots = torch.arange(layout.size, device=pos.device)
        slot_pos = torch.where(slots == slot, pos, state["slot_pos"])
        k_all, v_all = state["kv"]["k"], state["kv"]["v"]
        for i, layer in enumerate(_unbind(params["layers"], cfg.num_layers)):
            h = rms_norm(x, layer["norm1"], cfg.norm_eps)
            o, _, _ = attn.decode_attention(layer["attn"], h, cfg, k_all[i],
                                            v_all[i], slot_pos, pos, layout)
            x, _ = self._ffn_sublayer(layer, x, o)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = lm_logits(x, self._head(params))
        return logits, dict(state, pos=pos + 1, slot_pos=slot_pos)
