"""Build and load the port's CUDA kernels (``csrc/``) as one shared library.

Route: ``nvcc`` compiles each ``.cu`` source on its own (all started
together) into position-independent objects for ``sm_90a``, links them into
``librepro_torch.so`` with a plain C interface (``csrc/bindings.cu``), and
``ctypes`` loads it.  Nothing here includes PyTorch's headers, so a cold
build takes seconds.  The library lands in ``build/repro_torch/<hash>/``
at the repository root (override with ``REPRO_TORCH_BUILD_DIR``), keyed by
a hash of the sources and flags: an edited source builds anew, an
unchanged one loads the cached build.  The build happens at the first
launch, never at import.

Flags: ``-O3``, no ``--use_fast_math``; ``-fmad=false`` with IEEE divides
and square roots and no flush-to-zero, because XLA contracts none of the
sketch's ``logw / r + beta`` or ``c / (y * exp(r))`` and a contraction
could flip a floor or an argmin.  The flash-attention kernel's dot
products call ``__fmaf_rn`` explicitly, so they fuse all the same.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("icws_sketch.cu", "estimate_fields.cu", "estimate_pairs.cu",
           "countsketch_sparse.cu", "jl_sketch.cu",
           "linear_estimate_fields.cu", "dmh_sketch.cu",
           "sample_estimate_fields.cu", "countsketch_dense.cu",
           "flash_attention.cu", "bindings.cu")
HEADERS = ("u32.cuh", "packed.cuh", "fields_body.cuh")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ("-O3", "-std=c++17", ARCH, "-fmad=false", "-prec-div=true",
         "-prec-sqrt=true", "-ftz=false", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")
LIB_NAME = "librepro_torch.so"

_lock = threading.Lock()
_lib = None


class KernelError(RuntimeError):
    """A kernel failed to build or its launch was refused."""


def build_root() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise KernelError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                      "build on a machine with the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return build_root() / source_hash() / LIB_NAME


def _compile(out: pathlib.Path) -> None:
    """Compile every source in parallel, then link; the compiler's register
    and spill report (-Xptxas -v) is kept in ``build.log`` beside the library."""
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp = pathlib.Path(tmp)
        procs = []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            cmd = [cc, *FLAGS, "-I", str(CSRC), "-c", str(CSRC / name),
                   "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for name, _, p in procs:
            text, _ = p.communicate()
            log.append(f"== {name} (rc {p.returncode})\n{text}")
            if p.returncode != 0:
                failed.append(name)
        if not failed:
            lib_tmp = tmp / LIB_NAME
            link = subprocess.run(
                [cc, ARCH, "-shared", "-o", str(lib_tmp),
                 *(str(o) for _, o, _ in procs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link (rc {link.returncode})\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
        (out.parent / "build.log").write_text("\n".join(log))
        if failed:
            raise KernelError(f"nvcc failed for {', '.join(failed)}:\n"
                              + "\n".join(log))
        os.replace(lib_tmp, out)   # atomic: a concurrent process never loads half a file


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            _compile(path)
        lib = ctypes.CDLL(str(path))
        ptr, i32, u32, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                              ctypes.c_longlong)
        lib.repro_icws_sketch.argtypes = [ptr, ptr, ptr, i32, i32, i32, u32,
                                          i32, ptr, ptr, ptr, ptr, ptr, ptr]
        lib.repro_icws_sketch.restype = i32
        lib.repro_estimate_fields.argtypes = [ptr, ptr, ptr, ptr, i64, i64,
                                              i64, i64, ptr, ptr, i32, i32,
                                              i32, i32, ptr, ptr, ptr]
        lib.repro_estimate_fields.restype = i32
        lib.repro_countsketch_sparse.argtypes = [ptr, ptr, i32, i32, i32, i32,
                                                 u32, ptr, ptr]
        lib.repro_countsketch_sparse.restype = i32
        lib.repro_jl_sketch.argtypes = [ptr, ptr, i32, i32, i32, i32, u32, ptr,
                                        ptr]
        lib.repro_jl_sketch.restype = i32
        lib.repro_linear_estimate_fields.argtypes = [ptr, ptr, i64, i64, ptr,
                                                     ptr, i32, i32, i32, i32,
                                                     i32, ptr, ptr]
        lib.repro_linear_estimate_fields.restype = i32
        lib.repro_dmh_sketch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                         u32, i32, i32, i32, ptr, ptr, ptr,
                                         ptr, ptr, ptr]
        lib.repro_dmh_sketch.restype = i32
        lib.repro_sample_estimate_fields.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, i64, ptr,
            ptr, i32, i32, i32, i32, i32, ptr, ptr]
        lib.repro_sample_estimate_fields.restype = i32
        lib.repro_estimate_fields_packed.argtypes = \
            lib.repro_estimate_fields.argtypes
        lib.repro_estimate_fields_packed.restype = i32
        lib.repro_estimate_many.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32,
                                            i32, i32, ptr, ptr, ptr]
        lib.repro_estimate_many.restype = i32
        lib.repro_estimate_pairs.argtypes = [ptr, ptr, ptr, ptr, i64, i64,
                                             i64, i64, i32, i32, ptr, ptr,
                                             ptr]
        lib.repro_estimate_pairs.restype = i32
        lib.repro_estimate_one_vs_many.argtypes = [ptr, ptr, ptr, ptr, i64,
                                                   i64, i32, i32, ptr, ptr,
                                                   ptr]
        lib.repro_estimate_one_vs_many.restype = i32
        lib.repro_linear_estimate_fields_packed.argtypes = \
            lib.repro_linear_estimate_fields.argtypes
        lib.repro_linear_estimate_fields_packed.restype = i32
        lib.repro_sample_estimate_fields_packed.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64, i64, i64, i64, ptr,
            ptr, i32, i32, i32, i32, i32, i32, ptr, ptr]
        lib.repro_sample_estimate_fields_packed.restype = i32
        lib.repro_countsketch_dense.argtypes = [ptr, i64, i32, i32, u32, u32,
                                                i32, ptr, ptr, ptr]
        lib.repro_countsketch_dense.restype = i32
        lib.repro_flash_attention.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i64,
            i64, ctypes.c_float, ptr]
        lib.repro_flash_attention.restype = i32
        lib.repro_error_string.argtypes = [i32]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(err: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error (it then never ran)."""
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise KernelError(f"{kernel} launch failed: CUDA error {err} ({msg})")
