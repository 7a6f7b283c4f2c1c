"""Shared checks of the port's LM tests on the CPU (against the JAX
package) and on the card (against the CPU): logits within ``TOL`` of the
reference's largest magnitude, and greedy picks equal to the reference's
but at near ties; an engine whose steps record their logits; and the
training tests' tiny config, trainer settings and tolerances.  Imports
nothing of JAX."""
import dataclasses

import numpy as np
import torch

# two bf16 steps of the largest reference magnitude
TOL = 2 ** -6
# a gradient leaf within four bf16 steps of its largest reference
# magnitude: the backward runs through bf16 activations that the two
# frameworks round in other places, and the embedding's repeated rows add
# in f32 here, in bf16 in JAX's scatter-add
GRAD_TOL = 2 ** -5
# the share of values bit for bit the reference's (the port follows XLA's
# compiled rounding, so nearly all are)
SHARE = 0.75
# a routing flip is a near tie where the reference's k-th and (k+1)-th
# router probabilities lie within this share of the k-th: one f32 ulp of a
# router logit moves a token's k-th expert there, and a bf16 step of an
# upstream activation moves a logit by far less than the margin
ROUTE_MARGIN = 2 ** -6
# the training tests' model: ``tests/test_train_serve.py``'s
TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, d_ff=128, vocab_size=256)


def tiny_cfg(configs):
    """``configs`` (either package's) tinyllama-1.1b cut to ``TINY``."""
    return dataclasses.replace(configs.reduced("tinyllama-1.1b"), **TINY)


def trainer_config(TrainerConfig, AdamWConfig, tmp=None, steps=24,
                   total_steps=None, **kw):
    """``tests/test_train_serve.py``'s trainer settings, for either
    package's ``TrainerConfig``."""
    return TrainerConfig(
        steps=steps, global_batch=4, seq=32, microbatches=2,
        ckpt_dir=str(tmp) if tmp else None, ckpt_every=8, log_every=100,
        opt=AdamWConfig(lr=2e-3, warmup_steps=4,
                        total_steps=total_steps or steps), **kw)


def as_f32(a) -> np.ndarray:
    """A tensor (any dtype or device) or an array (a JAX one too) as f32
    numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor of the same dtype (bf16 by
    value)."""
    t = torch.from_numpy(as_f32(a).copy())
    return t.to(torch.bfloat16) if str(a.dtype) == "bfloat16" else t


def assert_close(got, want, what: str, share: float = SHARE):
    """``got`` within ``TOL`` of ``want``'s largest magnitude, with at
    least ``share`` of the values bit for bit equal."""
    a, b = as_f32(want), as_f32(got)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)
    assert err <= TOL, (what, err)
    assert (a == b).mean() >= share, (what, (a == b).mean())


def rel(got, want) -> float:
    """max |got - want| over max |want|."""
    a, b = as_f32(want), as_f32(got)
    return float(np.abs(a - b).max() / np.abs(a).max())


def near_tie_rows(got, want, tol: float = TOL) -> np.ndarray:
    """The rows of logits ``[..., V]`` (flattened) whose greedy pick in
    ``got`` differs from ``want``'s.  Each must sit at a near tie of
    ``want``: its top-2 margin within ``tol`` of ``want``'s largest
    magnitude; a pick that differs elsewhere fails the assertion."""
    a, b = as_f32(want), as_f32(got)
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    rows = np.flatnonzero(a.argmax(-1) != b.argmax(-1))
    top2 = np.sort(a[rows], axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    limit = tol * np.abs(a).max()
    assert (margin <= limit).all(), (rows, margin, limit)
    return rows


def route_flips(got_top_e, want_top_e, want_probs, k: int,
                exempt=None) -> np.ndarray:
    """The rows (tokens) whose top-k expert set in ``got_top_e`` ``[N, k]``
    differs from ``want_top_e``'s.  Each must sit at a near tie of the
    reference: its k-th and (k+1)-th probabilities in ``want_probs`` ``[N,
    E]`` within ``ROUTE_MARGIN`` of the k-th; rows in ``exempt`` (a boolean
    ``[N]``, say those routed apart in an earlier layer, whose inputs
    differ) need not.  A flip elsewhere fails the assertion."""
    got = np.sort(np.asarray(as_f32(got_top_e), np.int64), axis=-1)
    want = np.sort(np.asarray(as_f32(want_top_e), np.int64), axis=-1)
    rows = np.flatnonzero((got != want).any(-1))
    probs = as_f32(want_probs)
    top = np.sort(probs[rows], axis=-1)[:, ::-1]
    gap = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
    free = np.zeros(len(rows), bool) if exempt is None else \
        np.asarray(exempt)[rows]
    assert ((gap <= ROUTE_MARGIN) | free).all(), (rows, gap, ROUTE_MARGIN)
    return rows


class Recorded:
    """Wraps a ``ServeEngine`` (the port's or JAX's) so that each tick's
    decode step records its last-position logits as f32 numpy."""

    def __init__(self, engine):
        self.engine, self.logits = engine, []
        step = engine._step

        def recording(p, t, s):
            out, state = step(p, t, s)
            self.logits.append(as_f32(out[:, -1]))
            return out, state
        engine._step = recording
