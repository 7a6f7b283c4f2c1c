"""The port's fault-tolerance monitors (``repro_torch.ft``): host copies
of ``repro.ft``.  JAX's four monitor cases run on the port; the copy's
code equals the original's (its syntax tree below the module docstring),
and both give equal results on the same random heartbeat and step-time
streams."""
import ast
import pathlib

import numpy as np
import pytest

import repro.ft as jax_ft
import repro.ft.monitor as jax_monitor
import repro_torch.ft as port_ft
import repro_torch.ft.monitor as port_monitor
from repro_torch.ft import (HeartbeatRegistry, PreemptionHandler,
                            StragglerDetector, elastic_plan, plan_recovery)


def test_heartbeats_flag_silent_hosts():
    hb = HeartbeatRegistry(num_hosts=4, timeout=10.0)
    for h in range(3):
        hb.post(h, step=5, now=100.0)
    assert hb.dead_hosts(now=105.0) == {3}
    assert hb.dead_hosts(now=120.0) == {0, 1, 2, 3}
    hb.post(3, step=5, now=121.0)
    assert 3 not in hb.dead_hosts(now=122.0)


def test_straggler_detection_needs_persistence():
    sd = StragglerDetector(num_hosts=4, k_mad=4.0, patience=2)
    for step in range(3):
        for h in range(4):
            sd.record(h, 1.0 + 0.01 * h)
        assert sd.stragglers() == set()
    for _ in range(2):
        for h in range(4):
            sd.record(h, 10.0 if h == 2 else 1.0)
        s = sd.stragglers()
    assert s == {2}


def test_elastic_plan_and_recovery():
    data, model = elastic_plan(num_hosts=64, devices_per_host=4,
                               dead={1, 2}, model_parallel=16)
    assert model == 16 and data == (62 * 4) // 16
    hb = HeartbeatRegistry(num_hosts=4, timeout=10)
    sd = StragglerDetector(num_hosts=4)
    for h in range(4):
        hb.post(h, 0, now=0.0)
    act = plan_recovery(hb, sd, devices_per_host=4, model_parallel=4, now=5.0)
    assert act.kind == "none"
    for h in range(3):
        hb.post(h, 1, now=45.0)
    act = plan_recovery(hb, sd, devices_per_host=4, model_parallel=4, now=50.0)
    assert act.kind == "evict_and_rescale"
    assert act.dead_hosts == {3}
    assert act.new_mesh == (3, 4)


def test_preemption_handler_flag():
    ph = PreemptionHandler()
    assert not ph.should_save()
    ph.trigger_for_test()
    assert ph.should_save()


def _code(module) -> str:
    """The module's syntax tree without its docstring."""
    tree = ast.parse(pathlib.Path(module.__file__).read_text())
    body = tree.body[1:] if isinstance(getattr(tree.body[0], "value", None),
                                       ast.Constant) else tree.body
    return ast.dump(ast.Module(body=body, type_ignores=[]))


@pytest.mark.parametrize("pair", [(jax_monitor, port_monitor),
                                  (jax_ft, port_ft)])
def test_copy_is_the_original_code(pair):
    assert _code(pair[0]) == _code(pair[1])


def _drive(ft, seed: int):
    """A random cluster's history through one package's monitors: the
    dead hosts, stragglers and recovery plan after every round."""
    rng = np.random.default_rng(seed)
    hb = ft.HeartbeatRegistry(num_hosts=8, timeout=5.0)
    sd = ft.StragglerDetector(num_hosts=8, k_mad=3.0, patience=2)
    out = []
    for rnd in range(40):
        now = float(rnd)
        for h in range(8):
            if rng.random() < 0.8:
                hb.post(h, rnd, now=now)
            sd.record(h, float(rng.gamma(2.0, 1.0)) * (8 if h == rnd % 5
                                                       else 1))
        try:
            act = ft.plan_recovery(hb, sd, devices_per_host=4,
                                   model_parallel=4, now=now + 3.0)
            plan = (act.kind, sorted(act.dead_hosts), sorted(act.stragglers),
                    act.new_mesh)
        except RuntimeError as e:
            plan = str(e)
        out.append((sorted(hb.dead_hosts(now + 3.0)), plan))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_monitors_equal_jax_by_value(seed):
    assert _drive(port_ft, seed) == _drive(jax_ft, seed)
