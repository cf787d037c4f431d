"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded through ``ctypes``. Libraries go under the
checkout's ``build/swem_tpu_torch/`` (listed in ``.gitignore``), named by a
hash of the sources so an edited kernel is rebuilt. ``build`` starts one
``nvcc`` per source, all at once. Nothing is compiled at import time.
``refuse_gradients`` is the wrappers' shared guard: the kernels have no
backward.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "swem_tpu_torch"
KERNELS = ("em_loop", "read_memory")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile the named kernels in parallel where not built yet.

    Returns {name: {"seconds": wall time, "log": nvcc output}}; a library
    already on disk reports 0 seconds and an empty log. Raises if any
    compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    report = {name: {"seconds": 0.0, "log": ""} for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def refuse_gradients(kernel: str, jax_source: str, **inputs) -> None:
    """Raise if gradients are enabled and any of ``inputs`` requires grad.

    A kernel writes its outputs through ``ctypes`` into fresh tensors, which
    carry no autograd graph: a differentiable caller would lose its
    gradients without a word. Neither kernel has a backward in the JAX
    package either (``jax_source``), so the caller must run it under
    ``torch.no_grad()`` or on detached inputs.
    """
    import torch

    if not torch.is_grad_enabled():
        return
    needing = [name for name, t in inputs.items() if t.requires_grad]
    if needing:
        raise RuntimeError(
            f"{kernel} kernel: {', '.join(needing)} require grad, but the kernel has no "
            f"backward (nor has its TPU counterpart in {jax_source}); call it under "
            f"torch.no_grad() or on detached inputs")


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if it is not on disk."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
