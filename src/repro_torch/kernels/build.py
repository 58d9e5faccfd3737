"""Builds and loads the port's CUDA kernel libraries.

Each ``csrc/*.cu`` source has a plain C interface. ``CudaLibrary.load``
compiles it at first use with ``nvcc`` for ``sm_90a`` into
``build/repro_torch_kernels/`` at the root of the checkout, under a name that
hashes the source and the flags, and loads it with ``ctypes``. nvcc's output,
with ptxas's register and spill report, is kept beside the library as
``<library>.log``. No flag allows fast math or FMA contraction beyond what
each source writes out itself.

The helpers at the end are what every wrapper does around a launch: check
the tensors (``check_on_card``), pass the current stream (``stream_of``) and
count the launch, raising on a refused one (``count_launch``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
_count_lock = threading.Lock()

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built with it")


class CudaLibrary:
    """One kernel source, compiled once per source and flags, loaded once per
    process. ``bind`` declares ``argtypes``/``restype`` of its entries."""

    def __init__(self, name: str, source: Path, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = Path(source)
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        tag = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{tag.hexdigest()[:12]}.so"

    def log_path(self) -> Path:
        so = self.path()
        return so.with_name(so.name + ".log")

    def compile(self) -> Path:
        """Compile the library unless it is already built; safe to run from
        several processes at once (each writes its own file, then renames)."""
        so = self.path()
        if so.exists():
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n{proc.stderr}")
        self.log_path().write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
        return so

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.compile()))
                self._bind(lib)
                self._lib = lib
            return self._lib


# ---------------------------------------------------------------------- #
# what every wrapper does around a launch
# ---------------------------------------------------------------------- #
def check_on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on anything else,
    on mixed devices and on non-contiguous tensors."""
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t).__name__}")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def stream_of(device: torch.device) -> int:
    """The current stream of ``device``, as the kernels' ``void*`` argument."""
    return torch.cuda.current_stream(device).cuda_stream


def count_launch(fn: Callable, err: int, name: str) -> None:
    """Raise on a refused launch (``cudaGetLastError`` returned by the entry),
    else add one to ``fn.launches``."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    with _count_lock:
        fn.launches += 1
