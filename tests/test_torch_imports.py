"""The port stands alone: importing every ``repro_torch`` module pulls in
neither ``jax`` nor any module of the JAX package, and its entry points
default to the card, raising when there is none."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

# small shapes: one intra-op thread per test process, so that parallel
# test workers do not oversubscribe the cores
torch.set_num_threads(1)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("LOADED", ",".join(sorted(m for m in sys.modules
                               if m.startswith("repro_torch"))))
print("BAD", ",".join(bad))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("LOADED", "BAD")))
    loaded = set(lines["LOADED"].strip().split(","))
    assert len(loaded) >= 15
    assert {"repro_torch.optim.compression", "repro_torch.models.attention",
            "repro_torch.kernels.flash_attention", "repro_torch.data.merge",
            "repro_torch.core.wmh", "repro_torch.core.progmin",
            "repro_torch.core.rounding", "repro_torch.core.linear"} <= loaded
    assert lines["BAD"].strip() == ""


def test_entry_points_default_to_the_card():
    from repro_torch import (DatasetSearchIndex, SketchCorpus,
                             SketchSearchService)
    from repro_torch.data.store import CorpusStore
    for make in (lambda: SketchSearchService(m=8),
                 lambda: DatasetSearchIndex(m=8),
                 lambda: CorpusStore(m=8),
                 lambda: SketchCorpus(m=8)):
        if torch.cuda.is_available():
            assert make() is not None
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    with pytest.raises(ValueError, match="unsupported device"):
        DatasetSearchIndex(m=8, device="meta")
