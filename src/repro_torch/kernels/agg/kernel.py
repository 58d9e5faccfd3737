"""Wrappers of the aggregation kernels in ``csrc/agg.cu``.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. A tensor on the CPU goes to the plain version in
``ref.py``; a CUDA tensor goes to the kernel, or the wrapper raises. Outputs
are allocated here with ``torch.empty``; the kernels allocate nothing and
launch on the current stream. ``launches`` on each wrapper counts its kernel
launches (CPU calls do not count).

The library is compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/repro_torch_kernels/`` at the root of the checkout (``build()``),
under a name that hashes the source and flags, and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.agg import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "agg.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the aggregation kernels are built with it")


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libagg-{tag.hexdigest()[:12]}.so"


def build() -> ctypes.CDLL:
    """Compile (once per source and flags) and load the kernel library.

    nvcc's output, with ptxas's register and spill report, is kept beside
    the library as ``<library>.log``."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
            so.with_name(so.name + ".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        for name in ("agg_exact_fold", "agg_weighted_sum"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i64, ptr]
            fn.restype = i32
        lib.agg_exact_fold_into.argtypes = [ptr, ptr, f32, i32, i64, ptr]
        lib.agg_exact_fold_into.restype = i32
        lib.agg_exact_divide.argtypes = [ptr, ptr, f32, i64, ptr]
        lib.agg_exact_divide.restype = i32
        _lib = lib
        return lib


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def _launched(fn, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    with _count_lock:
        fn.launches += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_on_card(*tensors: torch.Tensor) -> bool:
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


def _check_stacked(d: torch.Tensor, w: torch.Tensor, den: torch.Tensor) -> bool:
    on_card = _check_on_card(d, w, den)
    if d.dim() != 2:
        raise ValueError(f"rows must be (C, N), got shape {tuple(d.shape)}")
    if d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rows must be float32 or bfloat16, got {d.dtype}")
    if w.dtype != torch.float32 or w.shape != (d.shape[0],) or d.shape[0] < 1:
        raise ValueError(f"weights must be float32 of shape ({d.shape[0]},)")
    if den.dtype != torch.float32 or den.shape != (1,):
        raise ValueError("denominator must be float32 of shape (1,)")
    return on_card


def _stacked(fn, name: str, d, w, den) -> torch.Tensor:
    C, N = d.shape
    out = torch.empty(N, dtype=torch.float32, device=d.device)
    if N == 0:
        return out
    lib = build()
    with torch.cuda.device(d.device):
        err = getattr(lib, name)(
            d.data_ptr(), int(d.dtype == torch.bfloat16), w.data_ptr(),
            den.data_ptr(), out.data_ptr(), C, N, _stream(d.device),
        )
    _launched(fn, err, name)
    return out


def exact_fold(d: torch.Tensor, w: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """Order-exact stacked fold, (C, N) f32/bf16 rows -> (N,) f32:
    ``fdiv(fold_c fmul(d[c], w[c]), den)``. Bit-identical to the JAX
    package's ``aggregate_flat(..., exact=True)``."""
    if not _check_stacked(d, w, den):
        return ref.exact_fold(d, w, den)
    return _stacked(exact_fold, "agg_exact_fold", d, w, den)


def weighted_aggregate(
    d: torch.Tensor, w: torch.Tensor, den: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Fused ``(w @ d) / den``, FMAs allowed; ``den`` defaults to
    ``max(sum(w), 1e-30)``."""
    if den is None:
        den = torch.clamp(w.sum(), min=1e-30).reshape(1)
    if not _check_stacked(d, w, den):
        return ref.weighted_aggregate(d, w, den)
    return _stacked(weighted_aggregate, "agg_weighted_sum", d, w, den)


def exact_fold_into(
    acc: Optional[torch.Tensor], d: torch.Tensor, w: float
) -> torch.Tensor:
    """Streaming exact fold of one float32 update ``d`` with weight ``w``
    (rounded once to float32): a new ``fmul(d, w)`` when ``acc`` is None,
    else ``acc = fadd(acc, fmul(d, w))`` in place. Returns the accumulator."""
    tensors = (d,) if acc is None else (acc, d)
    on_card = _check_on_card(*tensors)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the streaming fold takes float32 leaves, got {t.dtype}")
    if acc is not None:
        if acc.shape != d.shape:
            raise ValueError(f"shapes differ: {tuple(acc.shape)} vs {tuple(d.shape)}")
        if d.numel() and _overlap(acc, d):
            raise ValueError("the update must not overlap the accumulator")
    if not on_card:
        return ref.exact_fold_into(acc, d, w)
    first = acc is None
    if first:
        acc = torch.empty_like(d)
    if d.numel() == 0:
        return acc
    lib = build()
    with torch.cuda.device(d.device):
        err = lib.agg_exact_fold_into(
            acc.data_ptr(), d.data_ptr(), float(w), int(first), d.numel(),
            _stream(d.device),
        )
    _launched(exact_fold_into, err, "agg_exact_fold_into")
    return acc


def exact_divide(
    x: torch.Tensor, den: float, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """IEEE ``x / den`` of a float32 tensor, ``den`` rounded once to float32;
    ``out`` may be ``x`` (in place) or None (new tensor)."""
    tensors = (x,) if out is None else (x, out)
    on_card = _check_on_card(*tensors)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the divide takes float32 tensors, got {t.dtype}")
    if out is not None and out.shape != x.shape:
        raise ValueError(f"shapes differ: {tuple(out.shape)} vs {tuple(x.shape)}")
    if not on_card:
        return ref.exact_divide(x, den, out)
    if out is None:
        out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build()
    with torch.cuda.device(x.device):
        err = lib.agg_exact_divide(
            x.data_ptr(), out.data_ptr(), float(den), x.numel(), _stream(x.device)
        )
    _launched(exact_divide, err, "agg_exact_divide")
    return out


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a0 < b1 and b0 < a1


KERNELS = (exact_fold, weighted_aggregate, exact_fold_into, exact_divide)
for _fn in KERNELS:
    _fn.launches = 0
del _fn
