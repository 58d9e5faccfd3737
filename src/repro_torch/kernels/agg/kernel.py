"""Wrappers of the aggregation kernels in ``csrc/agg.cu``.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. A tensor on the CPU goes to the plain version in
``ref.py``; a CUDA tensor goes to the kernel, or the wrapper raises. Outputs
are allocated here with ``torch.empty``; the kernels allocate nothing and
launch on the current stream. ``launches`` on each wrapper counts its kernel
launches (CPU calls do not count).

The library is built and loaded at first use by ``repro_torch.kernels.build``
(``build()``, ``library_path()``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.agg import ref
from repro_torch.kernels.build import CudaLibrary, check_on_card, count_launch, stream_of

SOURCE = Path(__file__).resolve().parent / "csrc" / "agg.cu"


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    for name in ("agg_exact_fold", "agg_weighted_sum"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i64, ptr]
        fn.restype = i32
    lib.agg_exact_fold_into.argtypes = [ptr, ptr, f32, i32, i64, ptr]
    lib.agg_exact_fold_into.restype = i32
    lib.agg_exact_divide.argtypes = [ptr, ptr, f32, i64, ptr]
    lib.agg_exact_divide.restype = i32


LIBRARY = CudaLibrary("agg", SOURCE, _bind)
build = LIBRARY.load
library_path = LIBRARY.path


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def _check_stacked(d: torch.Tensor, w: torch.Tensor, den: torch.Tensor) -> bool:
    on_card = check_on_card(d, w, den)
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
            den.data_ptr(), out.data_ptr(), C, N, stream_of(d.device),
        )
    count_launch(fn, err, name)
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
    on_card = check_on_card(*tensors)
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
            stream_of(d.device),
        )
    count_launch(exact_fold_into, err, "agg_exact_fold_into")
    return acc


def exact_divide(
    x: torch.Tensor, den: float, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """IEEE ``x / den`` of a float32 tensor, ``den`` rounded once to float32;
    ``out`` may be ``x`` (in place) or None (new tensor)."""
    tensors = (x,) if out is None else (x, out)
    on_card = check_on_card(*tensors)
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
            x.data_ptr(), out.data_ptr(), float(den), x.numel(), stream_of(x.device)
        )
    count_launch(exact_divide, err, "agg_exact_divide")
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
