"""Chunked linear recurrences: SSD (Mamba-2-style selective SSM) and mLSTM,
and the sLSTM scan (the port of ``repro.models.ssd``).

Both linear recurrences have a scalar decay per head:

    S_t = a_t * S_{t-1} + b_t * k_t v_t^T          (state: N x P per head)
    y_t = q_t^T S_t

The selective scan maps to (a_t = exp(A * dt_t), b_t = dt_t); mLSTM to
(a_t = forget gate, b_t = input gate). The chunked form keeps the
intra-chunk work as batched products and carries a per-chunk state summary
through a scan over the chunks.

Plain PyTorch throughout, in float32: the JAX package computes these with
einsums and ``lax.scan`` / ``lax.associative_scan``, outside any Pallas
kernel. The scan over chunks combines in ``associative_scan``'s tree order
(``_associative_scan``), so the chunk states round as the JAX package's do;
the einsums and ``cumsum`` sum in the backend's own order. Every ``exp`` of
the chunked form and of the decode step is clamped to [-60, 60] where the
JAX package clips.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

F32 = torch.float32


def _associative_scan(combine: Callable, elems: Sequence[torch.Tensor], dim: int):
    """Inclusive scan of the tuple ``elems`` along ``dim`` with ``combine``
    (earlier, later) -> combined, in ``jax.lax.associative_scan``'s order:
    pairs combined, the half-length scan recursed, the even outputs
    combined from it, the two halves interleaved."""
    n = elems[0].shape[dim]
    if n < 2:
        return list(elems)

    def sl(x, start, stop=None, step=1):
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(start, stop, step)
        return x[tuple(idx)]

    reduced = combine([sl(e, 0, n - 1, 2) for e in elems], [sl(e, 1, None, 2) for e in elems])
    odd = _associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine([sl(e, 0, -1) for e in odd], [sl(e, 2, None, 2) for e in elems])
    else:
        even = combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
    return [_interleave(a, b, dim) for a, b in zip(even, odd)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``dim`` (a as long as b or one longer)."""
    n = b.shape[dim]
    pairs = torch.stack([a.narrow(dim, 0, n), b], dim=dim + 1).flatten(dim, dim + 1)
    return pairs if a.shape[dim] == n else torch.cat([pairs, a.narrow(dim, n, 1)], dim=dim)


def _chunk_combine(x, y):
    (p1, s1), (p2, s2) = x, y
    return [p1 * p2, s1 * p2[..., None, None] + s2]


def ssd_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    log_decay: torch.Tensor,
    gate: torch.Tensor,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked linear recurrence.

    q, k: (B, S, H, N); v: (B, S, H, P); log_decay, gate: (B, S, H).
    Returns (y: (B, S, H, P) in v's dtype, final_state: (B, H, N, P) f32).
    S must be a multiple of the chunk, or shorter than it.
    """
    B, S, H, N = q.shape
    P = v.shape[-1]
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"seq {S} not divisible by chunk {c}")
    nc = S // c

    qf = q.to(F32).reshape(B, nc, c, H, N)
    kf = k.to(F32).reshape(B, nc, c, H, N)
    vf = v.to(F32).reshape(B, nc, c, H, P)
    ld = log_decay.to(F32).reshape(B, nc, c, H)
    b = gate.to(F32).reshape(B, nc, c, H)

    L = torch.cumsum(ld, dim=2)  # inclusive within-chunk log decay (B, nc, c, H)
    Ltot = L[:, :, -1, :]  # (B, nc, H)

    # ---- intra-chunk ---------------------------------------------------- #
    scores = torch.einsum("bnihd,bnjhd->bnhij", qf, kf)  # (B, nc, H, c, c)
    ii = torch.arange(c, device=q.device)
    causal = ii[:, None] >= ii[None, :]
    # decay exp(L_i - L_j) * b_j, masked to j <= i
    dmat = torch.exp(torch.clamp(L[:, :, :, None, :] - L[:, :, None, :, :], -60.0, 60.0))
    dmat = torch.movedim(dmat, -1, 2)  # (B, nc, H, c_i, c_j)
    M = scores * dmat * torch.movedim(b, 2, -1)[:, :, :, None, :]
    M = torch.where(causal, M, 0.0)
    del scores, dmat
    y_intra = torch.einsum("bnhij,bnjhp->bnihp", M, vf)
    del M

    # ---- chunk summaries: T_j = exp(Ltot - L_j) * b_j ---------------------- #
    T = torch.exp(torch.clamp(Ltot[:, :, None, :] - L, -60.0, 60.0)) * b  # (B, nc, c, H)
    summary = torch.einsum("bnjhd,bnjhp->bnhdp", kf * T[..., None], vf)  # (B, nc, H, N, P)

    # ---- inter-chunk scan (inclusive: the state at the end of each chunk) - #
    pdecay = torch.exp(torch.clamp(Ltot, -60.0, 60.0))  # (B, nc, H)
    p_scan, s_scan = _associative_scan(_chunk_combine, (pdecay, summary), dim=1)
    del summary
    if initial_state is not None:
        s0 = initial_state[:, None].to(F32)  # (B, 1, H, N, P)
        state_end = s_scan + s0 * p_scan[..., None, None]
        first = s0
    else:
        state_end = s_scan
        first = torch.zeros((B, 1, H, N, P), dtype=F32, device=q.device)
    # the state entering chunk n is the state at the end of chunk n - 1
    init_states = torch.cat([first, state_end[:, :-1]], dim=1) if nc > 1 else first

    # ---- inter-chunk contribution -------------------------------------- #
    qdec = qf * torch.exp(torch.clamp(L, -60.0, 60.0))[..., None]  # (B, nc, c, H, N)
    y_inter = torch.einsum("bnihd,bnhdp->bnihp", qdec, init_states)

    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y.to(v.dtype), state_end[:, -1]


def ssd_decode_step(
    state: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    log_decay: torch.Tensor,
    gate: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrence step.

    state: (B, H, N, P); q, k: (B, H, N); v: (B, H, P); log_decay, gate:
    (B, H). Returns (y: (B, H, P) in v's dtype, new_state in state's dtype).
    """
    a = torch.exp(torch.clamp(log_decay.to(F32), -60.0, 60.0))
    sf = state.to(F32)
    new = a[..., None, None] * sf + gate.to(F32)[..., None, None] * (
        k.to(F32)[..., :, None] * v.to(F32)[..., None, :])
    y = torch.einsum("bhd,bhdp->bhp", q.to(F32), new)
    return y.to(v.dtype), new.to(state.dtype)


# --------------------------------------------------------------------- #
# sLSTM: scalar-memory recurrence with exponential gating (xLSTM).
# Elementwise state, sequential over the sequence.
# (Input-driven gates; no recurrent gate weights, as in the JAX package.)
# --------------------------------------------------------------------- #
def softplus(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's softplus, ``logaddexp(x, 0)``
    (``torch.nn.functional.softplus`` returns ``x`` itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -softplus(-x)


def slstm_scan(
    i_gate: torch.Tensor,
    f_gate: torch.Tensor,
    z: torch.Tensor,
    o_gate: torch.Tensor,
    initial: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """All inputs (B, S, D) pre-activations. Returns (h: (B, S, D) in z's
    dtype, (c, n, m) float32 (B, D) each).

    Stabilized exponential gating: m_t = max(f~ + m_{t-1}, i~);
    c_t = exp(f~ + m_{t-1} - m_t) c_{t-1} + exp(i~ - m_t) z_t; n_t alike.
    The elementwise activations of every step (log sigmoid of f, tanh of
    z, sigmoid of o) are taken for the whole sequence at once; only the
    recurrence runs step by step, S steps in order.
    """
    B, S, D = z.shape
    if initial is None:
        zeros = torch.zeros((B, D), dtype=F32, device=z.device)
        initial = (zeros, zeros, torch.full((B, D), -1e30, dtype=F32, device=z.device))
    c, n, m = initial
    it = i_gate.to(F32)
    log_f = log_sigmoid(f_gate.to(F32))
    tz = torch.tanh(z.to(F32))
    so = torch.sigmoid(o_gate.to(F32))
    hs = []
    for t in range(S):
        lf_m = log_f[:, t] + m
        m_new = torch.maximum(lf_m, it[:, t])
        keep = torch.exp(lf_m - m_new)
        take = torch.exp(it[:, t] - m_new)
        c = keep * c + take * tz[:, t]
        n = keep * n + take
        m = m_new
        hs.append(so[:, t] * c / torch.clamp(n, min=1.0))
    return torch.stack(hs, dim=1).to(z.dtype), (c, n, m)
