"""Build and load the port's CUDA kernels.

Every source under ``repro_torch/csrc`` compiles with one ``nvcc`` call
for ``sm_90a`` into one shared library with a plain C interface, loaded
with ``ctypes``.  The library lives in ``build/repro_torch/`` at the root
of the checkout, named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as is.  The build runs
at the first CUDA launch, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the C interface: name -> (argtypes, restype)
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURES = {
    "repro_flash_attention": ([_P, _P, _P, _P, ctypes.POINTER(_LL), _I, _I,
                               _I, _I, _I, _I, _I, _I, _F, _P], _I),
    "repro_rmsnorm": ([_P, _P, _P, _LL, _I, _I, _F, _P], _I),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
}


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float      # 0.0 when an existing build was loaded
    ptxas_log: str            # nvcc's -Xptxas -v report of that build

    def check(self, code: int, what: str) -> None:
        """Raise if a C entry point returned a CUDA error."""
        if code != 0:
            msg = self.lib.repro_cuda_error_string(code).decode()
            raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


_lock = threading.Lock()
_loaded: Optional[KernelLibrary] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _build(target: Path, log: Path) -> float:
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, target)
    return seconds


def load_library() -> KernelLibrary:
    """The loaded kernel library, building it first when needed."""
    global _loaded
    with _lock:
        if _loaded is None:
            digest = _digest()
            target = BUILD_DIR / f"librepro_torch_{digest}.so"
            log = BUILD_DIR / f"librepro_torch_{digest}.log"
            seconds = 0.0
            if not target.exists():
                seconds = _build(target, log)
            lib = ctypes.CDLL(str(target))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _loaded = KernelLibrary(
                lib=lib, path=target, build_seconds=seconds,
                ptxas_log=log.read_text() if log.exists() else "")
        return _loaded


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a C pointer value."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
