"""Wrappers of the three flash-attention kernels, and the table that picks one.

``flash_attention_bhsd`` has the JAX kernel's (B, H, S, D) indexing, but
takes any strides with a contiguous last dimension, so the model's
(B, S, H, D) tensors come in as transposed views, without a copy. A tensor
on the CPU goes to the plain version in ``ref.py``. A CUDA tensor goes to
one of three kernels, chosen by dtype and head dim alone (never by the mask):

=========  ==========  ======================================================
dtype      head dim    kernel (route)
=========  ==========  ======================================================
bfloat16   32, 64,     ``csrc/flash_sm90.cu``: TMA loads and ``wgmma`` on the
           128         tensor cores (``flash_forward_sm90``)
bfloat16   256         ``csrc/flash_sm90_d256.cu``: TMA loads and ``wgmma``
                       on the tensor cores, a register budget and KV tile of
                       its own (``flash_forward_sm90_d256``)
float32    32 to 256   ``csrc/flash.cu``: float32 products on the CUDA cores,
                       K and V through ``cp.async`` (``flash_forward``)
=========  ==========  ======================================================

Each route checks device, dtypes, shapes, ``D`` and the grid limits and
raises on what its kernel does not take. The tensor-core routes also need
what TMA needs: q, k and v at 16-byte-aligned addresses with strides that
are multiples of 16 bytes; they raise for a tensor that is not, and nothing
sends such a tensor to another kernel. A failed build or launch raises
too: no route falls back to another or to the plain version. The output
is allocated here, (B, Sq, H, D) contiguous, and returned as its
(B, H, Sq, D) view; the kernels allocate nothing and launch on the current
stream. ``flash_attention_bhsd.launches`` counts every kernel launch, and
each route's function (``flash_forward.launches``,
``flash_forward_sm90.launches``, ``flash_forward_sm90_d256.launches``)
counts its own (CPU calls count nowhere). ``flash_forward`` also takes
bfloat16 at every head dim when called directly, as ``chip_smoke.py`` does
to hold and time it beside the tensor-core kernels. The libraries are built at
first use by ``repro_torch.kernels.build``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, count_launch, stream_of
from repro_torch.kernels.flash_attention import ref

CSRC = Path(__file__).resolve().parent / "csrc"
HEAD_DIMS = (32, 64, 128, 256)
SM90_HEAD_DIMS = (32, 64, 128)
SM90_D256 = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_INT = 2**31 - 1
_TMA_ALIGN = 16  # bytes: TMA's base address and stride granule
_SM90_TILE = 128  # q rows per block of flash_sm90.cu and flash_sm90_d256.cu
# q rows per block of flash.cu (``Tile<D>::BQ``): 8 warps of 16 rows, of 8 at D 256
_SIMT_TILE = {32: 128, 64: 128, 128: 128, 256: 64}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_forward.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_float, ptr,
    ]
    lib.flash_attention_forward.restype = i32


def _bind_tma(entry: str):
    """The binder of a tensor-core entry: both take the same arguments."""
    def bind(lib: ctypes.CDLL) -> None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = getattr(lib, entry)
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32,
                       ctypes.c_float, ptr]
        fn.restype = i32
    return bind


LIBRARY = CudaLibrary("flash", CSRC / "flash.cu", _bind)
SM90_LIBRARY = CudaLibrary("flash_sm90", CSRC / "flash_sm90.cu",
                           _bind_tma("flash_attention_forward_sm90"))
SM90_D256_LIBRARY = CudaLibrary("flash_sm90_d256", CSRC / "flash_sm90_d256.cu",
                                _bind_tma("flash_attention_forward_sm90_d256"))


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> bool:
    """Raise on what neither a kernel nor the plain version takes; True for
    CUDA tensors (then also the limits both kernels share), False for CPU."""
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
    if max(Sq, Skv, window) > _MAX_INT:
        raise ValueError("sequence lengths and the window must fit in a 32-bit int")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError("the last dimension of q, k and v must be contiguous")
    return True


def route_of(dtype: torch.dtype, head_dim: int) -> str:
    """The route table of the module docstring: the name of the function
    that launches the kernel for CUDA tensors of this dtype and head dim."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "flash_forward_sm90"
    if dtype == torch.bfloat16 and head_dim == SM90_D256:
        return "flash_forward_sm90_d256"
    return "flash_forward"


def tma_strides(t: torch.Tensor) -> tuple:
    """(batch, head, sequence) strides of a (B, H, S, D) tensor for a TMA
    map; raises unless TMA can read it (16-byte-aligned base, strides that
    are multiples of 16 bytes). A dimension of one element is never stepped,
    so its stride is rounded up to the granule instead of refused."""
    unit = _TMA_ALIGN // t.element_size()
    if t.data_ptr() % _TMA_ALIGN:
        raise ValueError(f"TMA needs a {_TMA_ALIGN}-byte-aligned tensor; this one starts at "
                         f"byte {t.data_ptr() % _TMA_ALIGN} of a granule")
    out = []
    for size, stride in zip(t.shape[:3], t.stride()[:3]):
        if stride % unit:
            if size > 1:
                raise ValueError(f"TMA needs strides that are multiples of {_TMA_ALIGN} bytes; "
                                 f"got strides {t.stride()} of {t.element_size()}-byte elements")
            stride += unit - stride % unit
        out.append(max(stride, unit))
    return tuple(out)


def _output(q: torch.Tensor) -> torch.Tensor:
    B, H, Sq, D = q.shape
    return torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """``csrc/flash.cu`` on CUDA tensors, (B, H, S, D) -> (B, H, Sq, D):
    float32 or bfloat16 at any of ``HEAD_DIMS``."""
    if not _check(q, k, v, window):
        raise ValueError("flash_forward launches a CUDA kernel: got CPU tensors")
    B, H, Sq, D = q.shape
    if B * H * -(-Sq // _SIMT_TILE[D]) > _MAX_INT:
        raise ValueError(f"batch {B} x heads {H} x q tiles must fit in a 32-bit grid")
    o = _output(q)
    if Sq == 0:
        return o.transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(2), o.stride(1),
    )
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
            _DTYPES[q.dtype], B, H, k.shape[1], Sq, k.shape[2], D, k.shape[2],
            int(causal), window, D**-0.5, stream_of(q.device),
        )
    count_launch(flash_forward, err, "flash_attention_forward")
    return o.transpose(1, 2)


def _forward_tma(q, k, v, causal: bool, window: int, fn, head_dims: tuple,
                 library: CudaLibrary, entry: str) -> torch.Tensor:
    """What both tensor-core routes do around their launch: the checks,
    TMA's strides, the output, the call and the count on ``fn``."""
    if not _check(q, k, v, window):
        raise ValueError(f"{fn.__name__} launches a CUDA kernel: got CPU tensors")
    B, H, Sq, D = q.shape
    if q.dtype != torch.bfloat16 or D not in head_dims:
        raise ValueError(f"the tensor-core kernel takes bfloat16 at head dims {head_dims}, "
                         f"got {q.dtype} at {D}")
    if B * H * -(-Sq // _SM90_TILE) > _MAX_INT:
        raise ValueError(f"batch {B} x heads {H} x q tiles must fit in a 32-bit grid")
    qs, ks, vs = tma_strides(q), tma_strides(k), tma_strides(v)
    o = _output(q)
    if Sq == 0:
        return o.transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*qs, *ks, *vs, o.stride(0), o.stride(2), o.stride(1))
    lib = library.load()
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
            B, H, k.shape[1], Sq, k.shape[2], D, k.shape[2],
            int(causal), window, D**-0.5, stream_of(q.device),
        )
    count_launch(fn, err, entry)
    return o.transpose(1, 2)


def flash_forward_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0) -> torch.Tensor:
    """``csrc/flash_sm90.cu`` on CUDA tensors, (B, H, S, D) -> (B, H, Sq, D):
    bfloat16 at head dims 32, 64 and 128, q, k and v readable by TMA."""
    return _forward_tma(q, k, v, causal, window, flash_forward_sm90, SM90_HEAD_DIMS,
                        SM90_LIBRARY, "flash_attention_forward_sm90")


def flash_forward_sm90_d256(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, window: int = 0) -> torch.Tensor:
    """``csrc/flash_sm90_d256.cu`` on CUDA tensors, (B, H, S, D) -> (B, H, Sq, D):
    bfloat16 at head dim 256, q, k and v readable by TMA."""
    return _forward_tma(q, k, v, causal, window, flash_forward_sm90_d256, (SM90_D256,),
                        SM90_D256_LIBRARY, "flash_attention_forward_sm90_d256")


ROUTES = {"flash_forward": flash_forward, "flash_forward_sm90": flash_forward_sm90,
          "flash_forward_sm90_d256": flash_forward_sm90_d256}


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
    out = ROUTES[route_of(q.dtype, q.shape[3])](q, k, v, causal=causal, window=window)
    if q.shape[2]:  # an empty q launches nothing
        count_launch(flash_attention_bhsd, 0, "flash_attention_bhsd")
    return out


KERNELS = (flash_attention_bhsd, flash_forward, flash_forward_sm90, flash_forward_sm90_d256)
for _fn in KERNELS:
    _fn.launches = 0
del _fn
