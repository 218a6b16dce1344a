"""Build and load the port's CUDA kernels.

Every source under ``repro_torch/csrc`` compiles for ``sm_90a`` in its
own ``nvcc`` process, all started together, and one more ``nvcc`` call
links the objects into one shared library with a plain C interface,
loaded with ``ctypes``.  The library lives in ``build/repro_torch/`` at the root
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# the C interface: name -> (argtypes, restype)
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURES = {
    "repro_flash_attention_sm90": ([_P, _P, _P, _P, ctypes.POINTER(_LL), _I,
                                    _I, _I, _I, _I, _I, _I, _F, _P], _I),
    # the mma kernel's entry points also take the copy width
    "repro_flash_attention_mma_f32": ([_P, _P, _P, _P, ctypes.POINTER(_LL),
                                       _I, _I, _I, _I, _I, _I, _I, _F, _I,
                                       _P], _I),
    "repro_flash_attention_mma_bf16": ([_P, _P, _P, _P, ctypes.POINTER(_LL),
                                        _I, _I, _I, _I, _I, _I, _I, _F, _I,
                                        _P], _I),
    # the geometry: threads a row, vectors a thread
    "repro_rmsnorm": ([_P, _P, _P, _LL, _I, _I, _F, _I, _I, _P], _I),
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


def _run(procs) -> str:
    """Wait for every ``(cmd, Popen)``; their joined output, or raise."""
    out, failed = [], []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        out.append(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stdout}{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(out)


def _build(target: Path, log: Path) -> float:
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources()]
        compiles = []
        for src, obj in zip(sources(), objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            compiles.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        report = _run(compiles)
        lib = Path(tmp) / "lib.so"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(lib), *map(str, objs)]
        report += _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        log.write_text(report)
        os.replace(lib, target)
    return time.perf_counter() - t0


def load_library() -> KernelLibrary:
    """The loaded kernel library, building it first when needed."""
    global _loaded
    if _loaded is not None:
        return _loaded
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
    """PyTorch's current CUDA stream on ``device``, as a C pointer value
    (through the raw-stream call where this PyTorch has it: no Stream
    object is built, which costs a launch a few microseconds)."""
    import torch
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(index).cuda_stream
    return raw(index)
