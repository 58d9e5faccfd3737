"""Wrappers of the aggregation kernels in ``csrc/agg.cu``.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. A tensor on the CPU goes to the plain version in
``ref.py``; a CUDA tensor goes to the kernel, or the wrapper raises. Outputs
are allocated here with ``torch.empty``; the kernels allocate nothing and
launch on the current stream. ``launches`` on each wrapper counts its kernel
launches (CPU calls do not count).

The streaming fold takes a whole update tree in one call
(``exact_fold_into_tree``): ``fold_tables`` cuts the tree's leaves into the
kernel's leaf tables, one launch per ``TREE_LEAVES`` leaves, each leaf into
chunks of ``CHUNK`` elements. ``exact_fold_into`` is the same kernel on a
one-leaf tree.

The library is built and loaded at first use by ``repro_torch.kernels.build``
(``build()``, ``library_path()``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.agg import ref
from repro_torch.kernels.build import CudaLibrary, check_on_card, count_launch, stream_of

SOURCE = Path(__file__).resolve().parent / "csrc" / "agg.cu"

# the streaming fold's table (csrc/agg.cu: kTreeLeaves, kChunkPacks, FoldTable)
TREE_LEAVES = 120  # leaves per launch
CHUNK_PACKS = 2048  # 16-byte packs per chunk
CHUNK = 4 * CHUNK_PACKS  # float32 elements per chunk


class _FoldLeaf(ctypes.Structure):
    _fields_ = [("acc", ctypes.c_void_p), ("d", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("chunk0", ctypes.c_int), ("aligned", ctypes.c_int)]


class _FoldTable(ctypes.Structure):
    _fields_ = [("leaves", ctypes.c_int), ("chunks", ctypes.c_int), ("w", ctypes.c_float),
                ("pad", ctypes.c_int), ("leaf", _FoldLeaf * TREE_LEAVES)]


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    for name in ("agg_exact_fold", "agg_weighted_sum"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i64, ptr]
        fn.restype = i32
    lib.agg_exact_fold_tree.argtypes = [ptr, i32, ptr]
    lib.agg_exact_fold_tree.restype = i32
    lib.agg_fold_tree_layout.argtypes = [ptr]
    lib.agg_fold_tree_layout.restype = i32
    lib.agg_exact_divide.argtypes = [ptr, ptr, f32, i64, ptr]
    lib.agg_exact_divide.restype = i32
    layout = (ctypes.c_int * 3)()
    lib.agg_fold_tree_layout(layout)
    want = (TREE_LEAVES, CHUNK_PACKS, ctypes.sizeof(_FoldTable))
    if tuple(layout) != want:
        raise RuntimeError(f"agg.cu's fold table (leaves, packs, bytes) {tuple(layout)} "
                           f"is not the wrapper's {want}")


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


def _check_fold(accs: Optional[Sequence[torch.Tensor]], ds: Sequence[torch.Tensor]) -> bool:
    """Device, dtype, shape and contiguity of a fold's leaves, once for all;
    an accumulator leaf may share no byte with another leaf of the fold."""
    tensors = list(ds) if accs is None else [*accs, *ds]
    on_card = check_on_card(*tensors)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the streaming fold takes float32 leaves, got {t.dtype}")
    if accs is not None:
        if len(accs) != len(ds):
            raise ValueError(f"{len(accs)} accumulator leaves for {len(ds)} update leaves")
        for a, d in zip(accs, ds):
            if a.shape != d.shape:
                raise ValueError(f"shapes differ: {tuple(a.shape)} vs {tuple(d.shape)}")
        if _overlaps(accs, ds):
            raise ValueError("an accumulator leaf overlaps another leaf of the fold")
    return on_card


def fold_tables(leaves: Sequence[Tuple[int, int, int]]) -> List[Tuple[list, int]]:
    """The launches of one tree fold: ``leaves`` are ``(acc address, d
    address, n)`` with n > 0, in leaf order; each launch is ``(rows,
    chunks)``, at most ``TREE_LEAVES`` rows of ``(acc, d, n, chunk0,
    aligned)``. A leaf's chunks are ``chunk0`` up to the next row's
    ``chunk0`` (or ``chunks``), ``CHUNK`` elements each but its last;
    ``aligned`` is 1 when both addresses are 16-byte multiples."""
    tables = []
    for lo in range(0, len(leaves), TREE_LEAVES):
        rows, chunks = [], 0
        for acc, d, n in leaves[lo:lo + TREE_LEAVES]:
            rows.append((acc, d, n, chunks, int(acc % 16 == 0 and d % 16 == 0)))
            chunks += -(-n // CHUNK)
        tables.append((rows, chunks))
    return tables


def _launch_fold(fn, accs: Sequence[torch.Tensor], ds: Sequence[torch.Tensor], w: float,
                 first: bool) -> None:
    leaves = [(a.data_ptr(), d.data_ptr(), d.numel()) for a, d in zip(accs, ds) if d.numel()]
    if not leaves:
        return
    lib = build()
    dev = ds[0].device
    with torch.cuda.device(dev):
        stream = stream_of(dev)
        for rows, chunks in fold_tables(leaves):
            table = _FoldTable(len(rows), chunks, float(w), 0)
            for j, row in enumerate(rows):
                table.leaf[j] = _FoldLeaf(*row)
            err = lib.agg_exact_fold_tree(ctypes.byref(table), int(first), stream)
            count_launch(fn, err, "agg_exact_fold_tree")


def exact_fold_into_tree(
    accs: Optional[Sequence[torch.Tensor]], ds: Sequence[torch.Tensor], w: float
) -> List[torch.Tensor]:
    """Streaming exact fold of one update tree's float32 leaves ``ds`` with
    weight ``w`` (rounded once to float32), in one launch per
    ``TREE_LEAVES`` leaves: new leaves ``fmul(d, w)`` when ``accs`` is None,
    else ``acc = fadd(acc, fmul(d, w))`` in place. Returns the accumulator
    leaves."""
    ds = list(ds)
    if accs is not None:
        accs = list(accs)
    if not ds and not accs:
        return []
    if not _check_fold(accs, ds):
        return ref.exact_fold_into_tree(accs, ds, w)
    first = accs is None
    if first:
        accs = [torch.empty_like(d) for d in ds]
    _launch_fold(exact_fold_into_tree, accs, ds, w, first)
    return accs


def exact_fold_into(
    acc: Optional[torch.Tensor], d: torch.Tensor, w: float
) -> torch.Tensor:
    """``exact_fold_into_tree`` of a one-leaf tree: a new ``fmul(d, w)`` when
    ``acc`` is None, else ``acc = fadd(acc, fmul(d, w))`` in place. Returns
    the accumulator. Its launches count here, not on the tree entry."""
    if not _check_fold(None if acc is None else [acc], [d]):
        return ref.exact_fold_into(acc, d, w)
    first = acc is None
    if first:
        acc = torch.empty_like(d)
    _launch_fold(exact_fold_into, [acc], [d], w, first)
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


def _overlaps(accs: Sequence[torch.Tensor], ds: Sequence[torch.Tensor]) -> bool:
    """True when an accumulator leaf shares a byte with an update leaf or
    with another accumulator leaf (update leaves may share). One launch folds
    all leaves in no order, so this holds across leaves, not pair by pair:
    the spans sorted by start, each is checked against the furthest end
    before it (of any leaf for an accumulator, of accumulators for an
    update)."""
    spans = sorted(
        (t.data_ptr(), t.data_ptr() + t.numel() * t.element_size(), is_acc)
        for group, is_acc in ((accs, True), (ds, False)) for t in group if t.numel()
    )
    end_any = end_acc = 0
    for lo, hi, is_acc in spans:
        if lo < (end_any if is_acc else end_acc):
            return True
        end_any = max(end_any, hi)
        if is_acc:
            end_acc = max(end_acc, hi)
    return False


KERNELS = (exact_fold, weighted_aggregate, exact_fold_into, exact_fold_into_tree, exact_divide)
for _fn in KERNELS:
    _fn.launches = 0
del _fn
