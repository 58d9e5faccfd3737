"""Core layers: norms, rotary embeddings (RoPE / M-RoPE), gated MLPs (the
port of ``repro.models.layers``).

Parameters are plain dicts of tensors; init functions draw from the
caller's ``torch.Generator`` on its device (``normal * d_in**-0.5`` in
float32, cast to the parameter dtype, as the JAX package draws; the values
differ from JAX's, so parity tests carry the JAX weights across). An init
that builds more than one leaf passes each part to its ``keep(path, part)``
as soon as the part is drawn, ``path`` relative to the init's own tree: a
model-group rank's ``keep`` cuts the part to the rank's blocks
(``models.api``), so the rank never holds two leaves whole.

Products keep the JAX package's float32 accumulation
(``preferred_element_type``): ``dot`` rounds once to the input dtype and
``unembed_apply`` returns float32. On the card a bfloat16 product is one
cuBLAS call in bfloat16 with a float32 compute type; whether cuBLAS may
reduce split-K partial sums in bfloat16 is the process's
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``,
which this module leaves as the caller set it (the entry points turn it
off). On the CPU a bfloat16 product is computed in float32 and rounded once.

Under a model group (``launch.tensor_parallel``) the embedding and
unembedding hold a block of the (padded) vocabulary and the MLP's ``gate``
/ ``up`` a block of columns, ``down`` the same block of rows: the lookup is
masked to the block and summed over the group (exact: one term of each sum
is nonzero), the logits stay a vocabulary block, and the MLP is column-
then row-parallel with its output summed over the group.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import tensor_parallel as tp

Tree = Dict[str, torch.Tensor]


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out), accumulated in float32, in x's dtype.
    Operands of two dtypes are promoted first, as JAX promotes them (float32
    frames through a bfloat16 encoder: float32 products of the bfloat16
    weights' values)."""
    if x.dtype != w.dtype:
        common = torch.promote_types(x.dtype, w.dtype)
        return torch.matmul(x.to(common), w.to(common)).to(x.dtype)
    if x.dtype == torch.float32 or x.is_cuda:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


# --------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------- #
class MetaGenerator:
    """Stands in for a ``torch.Generator`` to build a tree's shapes and
    dtypes on the meta device, with no data (a full config's tree)."""

    device = torch.device("meta")


def keep_whole(path: Tuple[Any, ...], tree: Any, stack: Optional[int] = None) -> Any:
    """An init's ``keep`` that keeps every part whole (the one-process
    model)."""
    return tree


def keep_below(keep: Callable, *prefix: Any) -> Callable:
    """``keep`` for the init of the part at ``prefix``, whose paths are
    relative to that part."""
    return lambda path, tree: keep(prefix + tuple(path), tree)


def _normal(gen: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
               bias: bool = False) -> Tree:
    p = {"w": (_normal(gen, (d_in, d_out)) * (d_in**-0.5)).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense_apply(p: Tree, x: torch.Tensor) -> torch.Tensor:
    y = dot(x, p["w"])
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype) -> Tree:
    return {"emb": _normal(gen, (vocab, d)).to(dtype) * 0.02}


def embed_apply(p: Tree, tokens: torch.Tensor, vocab: int = 0) -> torch.Tensor:
    """The rows of ``tokens``; under a model group whose ``emb`` is a block
    of the ``vocab`` rows, each rank looks up the tokens of its block
    (zeros for the others) and the ranks' rows are summed."""
    emb = p["emb"]
    if not vocab or not tp.is_block(emb.shape[0], vocab):
        return F.embedding(tokens, emb)
    lo = tp.current_group().rank * emb.shape[0]
    local = tokens - lo
    inside = (local >= 0) & (local < emb.shape[0])
    rows = F.embedding(torch.where(inside, local, 0), emb)
    rows = rows * inside[..., None].to(rows.dtype)
    return tp.reduce_from_group(rows)


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` of two bfloat16 matrices: the exact products summed in
    float32 and rounded once to ``out_dtype`` (one cuBLAS call on the card)."""
    if a.is_cuda:
        return torch.mm(a, b) if out_dtype == a.dtype else torch.mm(a, b, out_dtype=out_dtype)
    return torch.mm(a.float(), b.float()).to(out_dtype)


def _split3(g: torch.Tensor) -> torch.Tensor:
    """float32 ``g`` (M, N) as three bfloat16 terms stacked to (3M, N) whose
    sum is ``g``: each term takes the next 8 significant bits of the rest."""
    hi = g.to(torch.bfloat16)
    rest = g - hi.float()
    mid = rest.to(torch.bfloat16)
    return torch.cat([hi, mid, (rest - mid.float()).to(torch.bfloat16)])


class _Float32Logits(torch.autograd.Function):
    """``x @ emb.T`` of two bfloat16 CUDA matrices with a float32 output: one
    cuBLAS product accumulating in float32, with no float32 copy of ``emb``.
    ``torch.mm(..., out_dtype=)`` has no derivative, so the backward is
    written out. The JAX package's transpose keeps the float32 cotangent
    (a float32 product rounded once to bfloat16); here the cotangent is
    split into three bfloat16 terms, whose products with bfloat16 operands
    are exact, so each gradient is still one float32-accumulating bfloat16
    product reading ``emb`` once (``gx`` sums its three partial products)."""

    @staticmethod
    def forward(ctx, x2d: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x2d, emb)
        return _mm(x2d, emb.t(), torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x2d, emb = ctx.saved_tensors
        gs = _split3(g.to(torch.float32))
        gx = gemb = None
        if ctx.needs_input_grad[0]:
            parts = _mm(gs, emb, torch.float32).view(3, *x2d.shape)
            gx = (parts[0] + parts[1] + parts[2]).to(x2d.dtype)
        if ctx.needs_input_grad[1]:
            gemb = _mm(gs.t(), x2d.repeat(3, 1), emb.dtype)
        return gx, gemb


def unembed_apply(p: Tree, x: torch.Tensor) -> torch.Tensor:
    """float32 logits through the (tied or separate) unembedding matrix."""
    emb = p["emb"]
    if x.dtype == torch.float32 and emb.dtype == torch.float32:
        return torch.matmul(x, emb.t())
    if x.is_cuda and x.dtype == emb.dtype == torch.bfloat16:
        # float32 out of the bf16 product: no float32 copy of emb
        flat = _Float32Logits.apply(x.reshape(-1, x.shape[-1]), emb)
        return flat.reshape(*x.shape[:-1], emb.shape[0])
    return torch.matmul(x.float(), emb.float().t())


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #
def rmsnorm_init(d: int, dtype: torch.dtype, device: torch.device) -> Tree:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p: Tree, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


# --------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device: torch.device = None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)


def _rotate_half_pairs(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, Dh/2)
    return _rotate_half_pairs(x, angles[..., None, :])  # broadcast over heads


def apply_mrope(
    x: torch.Tensor,
    positions: torch.Tensor,
    sections: Tuple[int, int, int],
    theta: float = 10_000.0,
) -> torch.Tensor:
    """M-RoPE (Qwen2-VL): rotary split into temporal/height/width sections.

    x: (B, S, H, Dh); positions: (3, B, S), one position stream per section.
    ``sections`` are sizes in *frequency* space (sum == Dh/2).
    """
    head_dim = x.shape[-1]
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {sections} must sum to head_dim/2 = {head_dim // 2}")
    freqs = rope_freqs(head_dim, theta, x.device)
    # which position stream drives each frequency band
    section_id = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                              device=x.device)
    pos_per_band = positions.to(torch.float32)[section_id]  # (Dh/2, B, S)
    angles = torch.movedim(pos_per_band, 0, -1) * freqs  # (B, S, Dh/2)
    return _rotate_half_pairs(x, angles[..., None, :])


# --------------------------------------------------------------------- #
# gated MLPs
# --------------------------------------------------------------------- #
def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype: torch.dtype,
             keep: Callable = keep_whole) -> Tree:
    return {
        "gate": keep(("gate",), dense_init(gen, d, d_ff, dtype)),
        "up": keep(("up",), dense_init(gen, d, d_ff, dtype)),
        "down": keep(("down",), dense_init(gen, d_ff, d, dtype)),
    }


def mlp_apply(p: Tree, x: torch.Tensor, activation: str = "swiglu",
              d_ff: int = 0) -> torch.Tensor:
    """The gated MLP; under a model group whose ``gate`` holds a block of
    the ``d_ff`` columns, column- then row-parallel."""
    split = bool(d_ff) and tp.is_block(p["gate"]["w"].shape[1], d_ff)
    if split:
        x = tp.copy_to_group(x)
    g = dense_apply(p["gate"], x)
    u = dense_apply(p["up"], x)
    if activation == "geglu":  # jax.nn.gelu's default is the tanh form
        h = F.gelu(g.to(torch.float32), approximate="tanh").to(x.dtype) * u
    else:  # swiglu
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    y = dense_apply(p["down"], h)
    return tp.reduce_from_group(y) if split else y
