"""The port stands alone: importing every ``repro_torch`` module pulls in
neither ``jax`` nor any module of the JAX package, and its entry points
default to the card, raising when there is none.  Every global name a
function of the port reads resolves to a module-level name, an import or
a builtin (a ``symtable`` walk): the CUDA launchers run only on the card,
so no CPU test calls them, and a lost import there would show only
there."""
import builtins
import os
import pathlib
import subprocess
import symtable
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
            "repro_torch.core.rounding", "repro_torch.core.linear",
            "repro_torch.core.minhash", "repro_torch.core.registry",
            "repro_torch.data.synthetic", "repro_torch.configs.gemma_7b",
            "repro_torch.models.transformer", "repro_torch.models.moe",
            "repro_torch.serve.engine",
            "repro_torch.launch.serve", "repro_torch.tree",
            "repro_torch.optim.adamw", "repro_torch.train.step",
            "repro_torch.train.trainer", "repro_torch.train.telemetry",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.store",
            "repro_torch.ft.monitor", "repro_torch.launch.train"} <= loaded
    assert lines["BAD"].strip() == ""


def test_entry_points_default_to_the_card():
    from repro_torch import (DatasetSearchIndex, SketchCorpus,
                             SketchSearchService)
    from repro_torch.configs import reduced
    from repro_torch.data.store import CorpusStore
    from repro_torch.launch.train import train
    from repro_torch.models import Model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    for make in (lambda: SketchSearchService(m=8),
                 lambda: DatasetSearchIndex(m=8),
                 lambda: CorpusStore(m=8),
                 lambda: SketchCorpus(m=8),
                 lambda: Model(reduced("tinyllama-1.1b")),
                 lambda: Trainer(reduced("tinyllama-1.1b"), TrainerConfig())):
        if torch.cuda.is_available():
            assert make() is not None
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    with pytest.raises(ValueError, match="unsupported device"):
        DatasetSearchIndex(m=8, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train("tinyllama-1.1b", steps=1)


# names a module has without binding them
_MODULE_NAMES = set(dir(builtins)) | {"__file__", "__name__", "__doc__",
                                      "__spec__", "__path__", "__package__",
                                      "__loader__", "__builtins__"}
PORT_FILES = sorted((SRC / "repro_torch").rglob("*.py"))


def unresolved_globals(path):
    """``(scope, line, name)`` for each global name read in ``path`` that
    no module-level binding, import or builtin provides (a name that a
    function binds through ``global`` counts as module-level)."""
    top = symtable.symtable(pathlib.Path(path).read_text(), str(path),
                            "exec")

    def binds(sym):
        return sym.is_assigned() or sym.is_imported() or sym.is_namespace()

    bound = {s.get_name() for s in top.get_symbols() if binds(s)}
    reads, tables = [], [top]
    while tables:
        t = tables.pop()
        tables.extend(t.get_children())
        for s in t.get_symbols():
            if s.is_declared_global() and s.is_assigned():
                bound.add(s.get_name())
            read = s.is_referenced() and (not binds(s) if t is top
                                          else s.is_global())
            if read:
                reads.append((t.get_name(), t.get_lineno(), s.get_name()))
    return sorted(r for r in set(reads)
                  if r[2] not in bound and r[2] not in _MODULE_NAMES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(SRC)))
def test_every_global_name_resolves(path):
    assert unresolved_globals(path) == []


def test_the_walk_flags_a_lost_launcher_import(tmp_path):
    """The fault that a CPU run missed once: the DMH launcher without its
    ``densify_probes`` import, in a copy of the module."""
    src = (SRC / "repro_torch" / "kernels" / "dmh_sketch.py").read_text()
    cut = src.replace("densify_probes, densify_sources",
                      "densify_sources", 1)
    assert cut != src
    planted = tmp_path / "dmh_sketch.py"
    planted.write_text(cut)
    assert [name for _, _, name in unresolved_globals(planted)] == [
        "densify_probes"]
