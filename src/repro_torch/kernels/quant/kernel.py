"""Wrappers of the quant kernels in ``csrc/quant.cu``.

Each wrapper checks device, dtype, shape, contiguity and alignment and
raises on what its kernel does not take. A tensor on the CPU goes to the
plain version in ``ref.py``; a CUDA tensor goes to the kernel, or the
wrapper raises. Outputs are allocated here; the kernels allocate nothing
and launch on the current stream. ``launches`` on each wrapper counts its
kernel launches (CPU calls do not count). The library is built at first use
by ``repro_torch.kernels.build``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.build import CudaLibrary, check_on_card, count_launch, stream_of
from repro_torch.kernels.quant import ref

BLOCK = 4096
SOURCE = Path(__file__).resolve().parent / "csrc" / "quant.cu"
_MAX_BLOCKS = 2**31 - 1  # gridDim.x


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.quant_quantize_blocks.argtypes = [ptr, ptr, ptr, i64, ptr]
    lib.quant_quantize_blocks.restype = i32
    lib.quant_dequantize_blocks.argtypes = [ptr, ptr, ptr, i64, ptr]
    lib.quant_dequantize_blocks.restype = i32


LIBRARY = CudaLibrary("quant", SOURCE, _bind)
build = LIBRARY.load
library_path = LIBRARY.path


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def _check_blocks(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != BLOCK:
        raise ValueError(f"{what} must be (NB, {BLOCK}), got shape {tuple(t.shape)}")
    if t.shape[0] > _MAX_BLOCKS:
        raise ValueError(f"{what}: {t.shape[0]} blocks exceed one launch's grid")


def _check_aligned(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the quant kernels take 16-byte aligned tensors")


def quantize_blocks(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (NB, 4096) f32 -> (q (NB, 4096) int8, scale (NB, 1) f32), bit-equal
    to ``ref.quantize_blocks``."""
    on_card = check_on_card(x)
    _check_blocks(x, torch.float32, "x")
    if not on_card:
        return ref.quantize_blocks(x)
    nb = x.shape[0]
    q = torch.empty((nb, BLOCK), dtype=torch.int8, device=x.device)
    scale = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    if nb == 0:
        return q, scale
    _check_aligned(x, q, scale)
    lib = build()
    with torch.cuda.device(x.device):
        err = lib.quant_quantize_blocks(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), nb, stream_of(x.device)
        )
    count_launch(quantize_blocks, err, "quant_quantize_blocks")
    return q, scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q (NB, 4096) int8, scale (NB, 1) f32 -> (NB, 4096) f32, bit-equal to
    ``ref.dequantize_blocks``."""
    on_card = check_on_card(q, scale)
    _check_blocks(q, torch.int8, "q")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (q.shape[0], 1):
        raise ValueError(f"scale must be float32 of shape ({q.shape[0]}, 1)")
    if not on_card:
        return ref.dequantize_blocks(q, scale)
    nb = q.shape[0]
    x = torch.empty((nb, BLOCK), dtype=torch.float32, device=q.device)
    if nb == 0:
        return x
    _check_aligned(q, x)
    lib = build()
    with torch.cuda.device(q.device):
        err = lib.quant_dequantize_blocks(
            q.data_ptr(), scale.data_ptr(), x.data_ptr(), nb, stream_of(q.device)
        )
    count_launch(dequantize_blocks, err, "quant_dequantize_blocks")
    return x


KERNELS = (quantize_blocks, dequantize_blocks)
for _fn in KERNELS:
    _fn.launches = 0
del _fn
