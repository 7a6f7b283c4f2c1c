"""The port's ``ServeEngine`` and launcher against the JAX package's on the
CPU, on the same weights (JAX's ``Model.init`` through
``convert.model_params_from_numpy``): JAX's two engine cases
(``tests/test_train_serve.py``: 5 requests on 3 slots, and an early EOS),
6 requests on 4 slots, and a run past ``max_seq``.

Both engines are driven tick by tick; each tick's logits are held within
``TOL`` = 2^-6 of the largest JAX logit (two bf16 steps: the port rounds
as XLA's CPU program does, see ``test_torch_lm.py``) and each slot's
greedy token must equal JAX's.  Where the two picks differ, JAX's top-2
margin on that slot must lie within the tolerance (a near tie): the test
says so and stops comparing tokens there, the logits compared through that
tick.  Without a near tie every request's output equals JAX's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_lm import TOL, Recorded, near_tie_rows, rel

from repro import configs as jax_configs
from repro.models import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import configs
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models import Model
from repro_torch.serve import Request, ServeEngine

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)


def _tiny(module):
    # tests/test_train_serve.py's _tiny_cfg(): tinyllama's reduced widths
    return dataclasses.replace(
        module.reduced("tinyllama-1.1b"), num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = _tiny(jax_configs), _tiny(configs)
    jm = JaxModel(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    params = model_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return jm, jp, Model(cfg, device="cpu"), params


def _engines(weights, slots, max_seq):
    jm, jp, model, params = weights
    return (Recorded(JaxEngine(jm, jp, batch_slots=slots, max_seq=max_seq)),
            Recorded(ServeEngine(model, params, batch_slots=slots,
                                 max_seq=max_seq)))


def _drive(rec, reqs, ticks=200):
    for r in reqs:
        rec.engine.submit(r)
    for _ in range(ticks):
        if all(r.done for r in reqs):
            break
        rec.engine.tick()


def _compare(jax_rec, port_rec, jax_reqs, port_reqs):
    """Logits tick by tick within TOL, greedy picks equal until a near tie;
    returns the tick of the first near tie whose picks differ, or None."""
    assert len(port_rec.logits) == len(jax_rec.logits)
    for tick, (want, got) in enumerate(zip(jax_rec.logits, port_rec.logits)):
        assert rel(got, want) <= TOL, (tick, rel(got, want))
        slots = near_tie_rows(got, want)
        if slots.size:
            print(f"near tie at tick {tick}, slots {slots.tolist()}: JAX's "
                  f"top-2 margin within {TOL} of its largest logit; tokens "
                  "compared up to this tick, logits through it")
            return tick
    assert [r.output for r in port_reqs] == [r.output for r in jax_reqs]
    return None


# JAX's case (tests/test_train_serve.py: more requests than slots), the
# card run's shape at reduced width, and a run past max_seq (JAX clamps
# the cache write and drops the slot table update)
@pytest.mark.parametrize("slots,requests,prompt_len,new,max_seq", [
    (3, 5, 2, 5, 64), (4, 6, 3, 8, 256), (1, 3, 2, 6, 8)])
def test_engine_tokens_equal_jax(weights, slots, requests, prompt_len, new,
                                 max_seq):
    recs = _engines(weights, slots, max_seq)
    outs = []
    for rec, make in zip(recs, (JaxRequest, Request)):
        reqs = [make(rid=i, prompt=[i + 1 + j for j in range(prompt_len)],
                     max_new_tokens=new) for i in range(requests)]
        _drive(rec, reqs)
        assert all(r.done and len(r.output) == new for r in reqs)
        assert all(0 <= t < 256 for r in reqs for t in r.output)
        outs.append(reqs)
    _compare(*recs, *outs)
    jax_state, state = recs[0].engine.state, recs[1].engine.state
    assert int(state["pos"]) == int(jax_state["pos"]) == len(recs[1].logits)
    assert np.array_equal(state["slot_pos"].numpy(),
                          np.asarray(jax_state["slot_pos"]))


def test_engine_eos_stops_early_as_jax(weights):
    recs = _engines(weights, slots=2, max_seq=64)
    outs = []
    for rec, make in zip(recs, (JaxRequest, Request)):
        probe = make(rid=0, prompt=[5], max_new_tokens=1)
        _drive(rec, [probe])
        req = make(rid=1, prompt=[5], max_new_tokens=10, eos=probe.output[0])
        _drive(rec, [req], ticks=100)
        assert req.done and len(req.output) == 1  # stopped at EOS at once
        outs.append([probe, req])
    _compare(*recs, *outs)


def test_run_until_drained_returns_an_empty_list_as_jax(weights):
    jm, jp, model, params = weights
    lists = []
    for engine, make in ((JaxEngine(jm, jp, batch_slots=2, max_seq=32),
                          JaxRequest),
                         (ServeEngine(model, params, batch_slots=2,
                                      max_seq=32), Request)):
        reqs = [make(rid=i, prompt=[3, 4], max_new_tokens=3)
                for i in range(3)]
        for r in reqs:
            engine.submit(r)
        lists.append(engine.run_until_drained())
        assert all(r.done for r in reqs)
        lists.append([r.output for r in reqs])
    assert lists[0] == lists[2] == []
    assert lists[1] == lists[3]


def test_launcher_serves_on_the_cpu_and_refuses_the_rest(capsys):
    reqs, seconds = launcher.serve("tinyllama-1.1b", requests=3, slots=2,
                                   max_new_tokens=4, device="cpu")
    assert all(r.done and len(r.output) == 4 for r in reqs) and seconds > 0
    again, _ = launcher.serve("tinyllama-1.1b", requests=3, slots=2,
                              max_new_tokens=4, device="cpu")
    assert [r.output for r in again] == [r.output for r in reqs]
    launcher.main(["--arch", "gemma-7b", "--requests", "2", "--device",
                   "cpu"])
    assert "gemma-7b: served 2 requests / 16 tokens" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="XLA HLO"):
        launcher.main(["--arch", "tinyllama-1.1b", "--dry-run"])
    with pytest.raises(NotImplementedError, match="Queue A 18c"):
        launcher.main(["--arch", "rwkv6-1.6b", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launcher.main(["--arch", "tinyllama-1.1b"])
