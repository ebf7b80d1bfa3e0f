"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles, with its own ``nvcc`` and all of them
at once, into ``build/kernels/lib<name>-<hash>.so`` at the repo root: a
plain C interface, no PyTorch headers, so a build takes seconds. The
hash covers the sources and the flags, so an edited kernel rebuilds and
an unchanged one is reused. Nothing here runs at import: the CPU tests
import every module on a machine with no ``nvcc``.

If a build fails the caller gets the compiler's output in the error;
there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("flash_fwd", "flash_fwd_wgmma", "flash_bwd", "flash_bwd_wgmma",
           "flash_bwd_dq_wgmma", "decode_attention", "decode_attention_wgmma",
           "grouped_mm", "grouped_mm_wgmma", "wire_codec", "adam")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs = {}


def _nvcc():
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's kernels")


def _library_path(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all():
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: compiler
    output}`` for what was built (ptxas lists registers, shared memory
    and spills per kernel); raises with the output if any build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in SOURCES:
            out = _library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(_CSRC / f"{name}.cu")]
            jobs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = {}, []
        for name, out, tmp, proc in jobs:
            logs[name], _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{name}.cu: nvcc exited {proc.returncode}"
                              f"\n{logs[name]}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return logs


def load(name):
    """The ctypes library of kernel source ``name``, built if needed."""
    if name not in SOURCES:
        raise ValueError(f"{name!r} is not a kernel source: {SOURCES}")
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_library_path(name)))
        _libs[name] = lib
    return lib
