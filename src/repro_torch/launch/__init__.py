"""Device meshes for sharded serving (port of ``repro.launch``)."""
from .mesh import (CorpusMesh, make_corpus_mesh, make_host_mesh,
                   register_world_axis)

__all__ = ["CorpusMesh", "make_corpus_mesh", "make_host_mesh",
           "register_world_axis"]
