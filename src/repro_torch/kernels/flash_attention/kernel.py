"""Wrapper of the flash-attention kernel in ``csrc/flash.cu``.

``flash_attention_bhsd`` has the JAX kernel's (B, H, S, D) indexing, but
takes any strides with a contiguous last dimension, so the model's
(B, S, H, D) tensors come in as transposed views, without a copy. It checks
device, dtypes, shapes, ``D`` and the grid limits and raises on what the
kernel does not take. A tensor on the CPU goes to the plain version in
``ref.py``; a CUDA tensor goes to the kernel, or the wrapper raises. The
output is allocated here, (B, Sq, H, D) contiguous, and returned as its
(B, H, Sq, D) view; the kernel allocates nothing and launches on the current
stream. ``flash_attention_bhsd.launches`` counts kernel launches (CPU calls
do not count). The library is built at first use by
``repro_torch.kernels.build``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, count_launch, stream_of
from repro_torch.kernels.flash_attention import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash.cu"
HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65_535  # gridDim.y (heads) and gridDim.z (batch)
_MAX_INT = 2**31 - 1


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_forward.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_float, ptr,
    ]
    lib.flash_attention_forward.restype = i32


LIBRARY = CudaLibrary("flash", SOURCE, _bind)
build = LIBRARY.load
library_path = LIBRARY.path


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> bool:
    """Raise on what neither the kernel nor its plain version takes; True
    for CUDA tensors (then also the kernel's own limits), False for CPU."""
    for t in (q, k, v):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t).__name__}")
        if t.device != q.device:
            raise ValueError(f"tensors on different devices: {q.device} and {t.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"q, k and v must share a dtype: {q.dtype} and {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"expected (B, H, S, D) tensors, got shape {tuple(t.shape)}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got {q.dtype}")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v must be (B, Hkv, Skv, D) = ({B}, Hkv, Skv, {D}), "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"query heads {H} are not a multiple of kv heads {Hkv}")
    if Skv == 0:
        raise ValueError("no keys: attention over an empty sequence")
    if window < 0:
        raise ValueError(f"window {window} must be >= 0")
    if q.device.type == "cpu":
        return False
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    if B > _MAX_GRID_YZ or H > _MAX_GRID_YZ:
        raise ValueError(f"batch {B} and heads {H} must each be <= {_MAX_GRID_YZ} (grid y, z)")
    if max(Sq, Skv, window) > _MAX_INT:
        raise ValueError("sequence lengths and the window must fit in a 32-bit int")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError("the last dimension of q, k and v must be contiguous")
    return True


def flash_attention_bhsd(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Forward flash attention on (B, H, S, D) indexing -> (B, H, Sq, D) in
    q's dtype, the same function as ``ref.reference_attention`` on the
    transposed tensors."""
    if not _check(q, k, v, window):
        out = ref.reference_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      causal=causal, window=window)
        return out.transpose(1, 2)
    B, H, Sq, D = q.shape
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if Sq == 0:
        return o.transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(2), o.stride(1),
    )
    lib = build()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
            _DTYPES[q.dtype], B, H, k.shape[1], Sq, k.shape[2], D, k.shape[2],
            int(causal), window, D**-0.5, stream_of(q.device),
        )
    count_launch(flash_attention_bhsd, err, "flash_attention_forward")
    return o.transpose(1, 2)


KERNELS = (flash_attention_bhsd,)
for _fn in KERNELS:
    _fn.launches = 0
del _fn
