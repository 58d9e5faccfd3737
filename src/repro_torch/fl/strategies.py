"""Server aggregation strategies (paper Table 7), the port of
``repro.fl.strategies``.

A ``ServerStrategy`` consumes the aggregated client delta (mean client
model minus the global one) and produces new global weights. Trees hold
``torch.Tensor``s; every operation runs on the device of the leaves it
reads, in the JAX package's operation order, one IEEE operation at a time
(no fused multiply-add), so float32 trees give the JAX package's bits.

FedAvg      McMahan et al. 2017          global = mean of client models
FedProx     Li et al. 2020               FedAvg server + proximal client term
FedAdam/
FedAdagrad/
FedYogi     Reddi et al. 2021            adaptive server optimizers on -delta
FedDyn      Acar et al. 2021             dynamic regularizer state h
FedBuff     Nguyen et al. 2022           buffered async aggregation (K of N)
FedAsync    Xie et al. 2019              apply each update on arrival

Two rules keep the bits. A division by a Python number divides by a 0-d
tensor on the leaf's device (on CUDA, ``tensor / python_float`` is a
reciprocal multiply). The staleness weight is computed on the host, in
float32, as ``1 / pow(1 + s, exp)``: torch's CPU ``pow`` gives XLA's bits at
the exponents 0.5, 1 and 2 (not at every exponent; ROADMAP Queue 3), and the
card's ``pow`` is another implementation again.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels.agg.ops import aggregate_tree, fold_into, stack_client_trees

Tree = Any


def tree_zeros_like(t: Tree) -> Tree:
    return tree_map(torch.zeros_like, t)


def _scalar(value: Any, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype on its device."""
    return torch.as_tensor(value).to(dtype=like.dtype, device=like.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``sqrt`` (XLA's), on any device.

    torch's CPU ``sqrt`` misrounds float32 (6 541 of 10^6 random inputs on
    an AVX-512 host) and float64 alike, so the root is taken in float64,
    rounded to float32 and then corrected: of ``r`` and its two neighbours
    the right one is the one whose rounding interval holds ``x``. The
    interval's ends and their squares are exact in float64 (25 and 50
    significant bits), and no float32 ``x`` sits on one."""
    if x.dtype != torch.float32:
        return torch.sqrt(x)
    x64 = x.to(torch.float64)
    r = torch.sqrt(x64).to(torch.float32)
    lo = torch.nextafter(r, torch.full_like(r, -float("inf")))
    hi = torch.nextafter(r, torch.full_like(r, float("inf")))
    r64 = r.to(torch.float64)
    below = (lo.to(torch.float64) + r64) * 0.5
    above = (r64 + hi.to(torch.float64)) * 0.5
    out = torch.where(x64 < below * below, lo, torch.where(x64 > above * above, hi, r))
    # zeros, infinities and NaNs (and negative inputs) as sqrt gives them
    return torch.where(torch.isfinite(x) & (x > 0), out, torch.sqrt(x))


def _sq_dist(params: Tree, global_params: Tree) -> torch.Tensor:
    """``sum over leaves of sum((w - g)**2)`` in float32, leaves in tree
    order, as the JAX package's Python ``sum`` adds them."""
    sq = tree_map(
        lambda w, g: torch.sum((w.to(torch.float32) - g.to(torch.float32)) ** 2),
        params,
        global_params,
    )
    total = None
    for leaf in tree_leaves(sq):
        total = leaf if total is None else total + leaf
    return total if total is not None else torch.zeros((), dtype=torch.float32)


class ServerStrategy:
    """Base: ``init(params) -> state`` and
    ``apply(params, agg_delta, state) -> (new_params, new_state)``.

    ``agg_delta`` is mean(client_model) - global (the model-update convention
    of the paper's aggregator roles).
    """

    name = "base"

    def init(self, params: Tree) -> Tree:
        return ()

    def apply(self, params: Tree, agg_delta: Tree, state: Tree) -> Tuple[Tree, Tree]:
        raise NotImplementedError

    # client-side hook: loss regularizer (FedProx/FedDyn need one)
    def client_loss_extra(
        self, params: Tree, global_params: Tree, state: Tree
    ) -> torch.Tensor:
        """A 0-d float32 tensor on the device of ``params``' first leaf."""
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return torch.zeros((), dtype=torch.float32, device=device)


@dataclasses.dataclass
class FedAvg(ServerStrategy):
    server_lr: float = 1.0
    name: str = "fedavg"

    def apply(self, params, agg_delta, state):
        new = tree_map(lambda p, d: p + self.server_lr * d, params, agg_delta)
        return new, state


@dataclasses.dataclass
class FedProx(ServerStrategy):
    """Server side is FedAvg; the proximal mu/2 * ||w - w_g||^2 term is added
    to the client loss via ``client_loss_extra``."""

    mu: float = 0.01
    server_lr: float = 1.0
    name: str = "fedprox"

    def apply(self, params, agg_delta, state):
        new = tree_map(lambda p, d: p + self.server_lr * d, params, agg_delta)
        return new, state

    def client_loss_extra(self, params, global_params, state):
        return 0.5 * self.mu * _sq_dist(params, global_params)


class _AdaptiveServer(ServerStrategy):
    """Shared m/v machinery of FedAdam / FedAdagrad / FedYogi (Reddi 2021)."""

    def __init__(self, lr=0.01, beta1=0.9, beta2=0.99, tau=1e-3):
        self.lr, self.beta1, self.beta2, self.tau = lr, beta1, beta2, tau

    def init(self, params: Tree) -> Tree:
        return {
            "m": tree_zeros_like(params),
            "v": tree_map(lambda p: torch.full_like(p, self.tau**2), params),
        }

    def _update_v(self, v: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, params, agg_delta, state):
        m = tree_map(
            lambda m_, d: self.beta1 * m_ + (1 - self.beta1) * d, state["m"], agg_delta
        )
        v = tree_map(lambda v_, d: self._update_v(v_, d * d), state["v"], agg_delta)
        new = tree_map(
            lambda p, m_, v_: p + self.lr * m_ / (_sqrt(v_) + self.tau),
            params,
            m,
            v,
        )
        return new, {"m": m, "v": v}


class FedAdam(_AdaptiveServer):
    name = "fedadam"

    def _update_v(self, v, d2):
        return self.beta2 * v + (1 - self.beta2) * d2


class FedAdagrad(_AdaptiveServer):
    name = "fedadagrad"

    def _update_v(self, v, d2):
        return v + d2


class FedYogi(_AdaptiveServer):
    name = "fedyogi"

    def _update_v(self, v, d2):
        return v - (1 - self.beta2) * d2 * torch.sign(v - d2)


@dataclasses.dataclass
class FedDyn(ServerStrategy):
    """FedDyn (Acar et al. 2021): server keeps a running h state that debiases
    partial participation; client adds a linear+proximal dynamic regularizer."""

    alpha: float = 0.01
    name: str = "feddyn"

    def init(self, params: Tree) -> Tree:
        return {"h": tree_zeros_like(params)}

    def apply(self, params, agg_delta, state):
        h = tree_map(lambda h_, d: h_ - self.alpha * d, state["h"], agg_delta)
        new = tree_map(
            lambda p, d, h_: p + d - h_ / _scalar(self.alpha, h_), params, agg_delta, h
        )
        return new, {"h": h}

    def client_loss_extra(self, params, global_params, state):
        # linearized penalty: -<grad_prev, w> + alpha/2 ||w - w_g||^2
        return 0.5 * self.alpha * _sq_dist(params, global_params)


def _host_staleness_weight(staleness: Any, exp: float) -> torch.Tensor:
    """float32 ``1 / pow(1 + s, exp)`` on the host, as a 0-d tensor."""
    s = torch.as_tensor(staleness).to(device="cpu", dtype=torch.float32)
    return torch.ones((), dtype=torch.float32) / torch.pow(1.0 + s, exp)


class _BufferedBatchMixin:
    """Streaming and stacked absorption for the buffered async strategies.

    ``accumulate_stream(state, delta, staleness)`` folds one update into the
    strategy state as it arrives, through the fold kernel's tree entry
    (``fold_into``: ``acc = fadd(acc, fmul(d, w))``, the accumulator leaves
    updated in place, so the state passed in must not be reused). The
    accumulator starts from the explicit zeros of ``init``, so the first fold
    is ``0 + w*d`` and turns -0.0 into +0.0, as the incremental
    ``accumulate`` does.

    ``accumulate_batch(state, deltas, staleness)`` absorbs a buffer of
    updates at once: on an empty state, the per-update weights of
    ``accumulate``, one stacked exact fold per leaf (``aggregate_tree``,
    denominator 1), then ``acc + summed``; on a part-filled state, one
    ``accumulate_stream`` per update (in place, as above).

    Both give ``accumulate``'s bits, on every device. Dispatch is by the
    leaves' device, as the port's ``weighted_mean`` does: ``fused`` is
    accepted for the JAX package's signature and changes nothing.
    """

    def _update_weight(self, staleness: Any) -> torch.Tensor:
        raise NotImplementedError

    def accumulate_stream(
        self,
        state: Tree,
        delta: Tree,
        staleness: int,
        fused: Any = None,
    ) -> Tree:
        w = float(self._update_weight(int(staleness)))
        acc = fold_into(state["acc"], delta, w)
        return {"acc": acc, "count": state["count"] + 1}

    def accumulate_batch(
        self,
        state: Tree,
        deltas: Sequence[Tree],
        staleness: Sequence[int],
        fused: Any = None,
    ) -> Tree:
        if not deltas:
            return state
        stacked = None
        if int(state["count"]) == 0:
            stacked = stack_client_trees(list(deltas))
        leaves = tree_leaves(stacked) if stacked is not None else []
        if leaves:
            w = torch.stack([self._update_weight(int(s)) for s in staleness]).to(
                leaves[0].device
            )
            summed = aggregate_tree(stacked, w, denom=1.0, exact=True)
            # add into the (zeros) acc rather than replacing it: the
            # incremental chain starts with ``0 + w_0*d_0``, which turns -0.0
            # into +0.0; this add does the same
            acc = tree_map(lambda a, s: a + s, state["acc"], summed)
            return {"acc": acc, "count": state["count"] + len(deltas)}
        for d, s in zip(deltas, staleness):
            state = self.accumulate_stream(state, d, s)
        return state

    def accumulate(self, state: Tree, delta: Tree, staleness: Any) -> Tree:
        w = self._update_weight(staleness)
        acc = tree_map(lambda a, d: a + _scalar(w, d) * d, state["acc"], delta)
        return {"acc": acc, "count": state["count"] + 1}

    def init(self, params: Tree) -> Tree:
        return {"acc": tree_zeros_like(params), "count": torch.zeros((), dtype=torch.int32)}

    def staleness_weight(self, staleness: Any) -> torch.Tensor:
        return _host_staleness_weight(staleness, self.staleness_exp)


@dataclasses.dataclass
class FedBuff(_BufferedBatchMixin, ServerStrategy):
    """Buffered asynchronous aggregation: the server applies an update once
    ``buffer_size`` client deltas have arrived (Nguyen et al. 2022). The
    buffering itself happens in the aggregator role; this strategy tracks
    staleness-weighted averaging state."""

    buffer_size: int = 10
    server_lr: float = 1.0
    staleness_exp: float = 0.5
    name: str = "fedbuff"

    def _update_weight(self, staleness: Any) -> torch.Tensor:
        return self.staleness_weight(staleness)

    def ready(self, state: Tree) -> torch.Tensor:
        return state["count"] >= self.buffer_size

    def apply(self, params, agg_delta, state):
        # agg_delta unused: the buffer IS the aggregate
        count = torch.clamp(torch.as_tensor(state["count"]), min=1).to(torch.float32)
        new = tree_map(
            lambda p, a: p + self.server_lr * a / _scalar(count, a), params, state["acc"]
        )
        return new, self.init(params)


@dataclasses.dataclass
class FedAsync(_BufferedBatchMixin, ServerStrategy):
    """FedAsync (Xie et al. 2019): apply every update the moment it arrives,
    mixing it in with a staleness-decayed rate; the ``buffer_size=1`` end of
    the async family, with FedBuff's ``accumulate/ready/apply`` surface."""

    alpha: float = 0.6
    staleness_exp: float = 0.5
    name: str = "fedasync"

    def _update_weight(self, staleness: Any) -> torch.Tensor:
        return self.alpha * self.staleness_weight(staleness)

    def ready(self, state: Tree) -> torch.Tensor:
        return state["count"] >= 1

    def apply(self, params, agg_delta, state):
        new = tree_map(lambda p, a: p + a, params, state["acc"])
        return new, self.init(params)


_STRATEGIES: Dict[str, Callable[..., ServerStrategy]] = {
    "fedavg": FedAvg,
    "fedprox": FedProx,
    "fedadam": FedAdam,
    "fedadagrad": FedAdagrad,
    "fedyogi": FedYogi,
    "feddyn": FedDyn,
    "fedbuff": FedBuff,
    "fedasync": FedAsync,
}


def register_strategy(
    name: str, factory: Callable[..., ServerStrategy], *, overwrite: bool = False
) -> None:
    """Register a server strategy under ``name``, reachable through
    ``get_strategy`` without editing this module."""
    if not overwrite and name in _STRATEGIES:
        raise ValueError(
            f"strategy {name!r} already registered (pass overwrite=True to replace)"
        )
    _STRATEGIES[name] = factory


def registered_strategies() -> List[str]:
    return sorted(_STRATEGIES)


def get_strategy(name: str, **kwargs: Any) -> ServerStrategy:
    try:
        return _STRATEGIES[name](**kwargs)
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; available: {sorted(_STRATEGIES)}"
        ) from None
