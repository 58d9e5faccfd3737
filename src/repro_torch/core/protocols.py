"""Round protocols — *what* flows on a channel per round step (the port of
``repro.core.protocols``).

``WeightSync`` is the classic FL protocol: broadcast weights down, train,
upload sample-weighted updates, fold a sorted-src streaming mean. A protocol
binds to a role instance lazily (``Role.protocol``) and may rewrite the
role's tasklet chain (``rewrite_chain``) through the Table 1 surgical-edit
API.

Two more protocols reuse the stock role chains:

* ``VerticalSplit`` — feature-split vertical FL: parties hold disjoint
  feature columns, the label-holding head owns the bias and the labels, and
  every batch exchanges activations down-up and gradients up-down;
* ``GossipAvg`` — serverless gossip: each trainer averages with its ring
  neighbours every round (``_fold_allreduce``, sorted-source fold).

Resolution order for a role's protocol name: the ``round_protocol``
hyperparam, else the ``protocol`` attribute of the role's protocol channel
in the TAG, else ``weight-sync``. Register your own with
``register_protocol``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import tree_from_numpy
from repro_torch.core.composer import Composer, ComposerError, Tasklet
from repro_torch.core.roles import Role, StreamingMean, _fold_allreduce, await_peer


# ------------------------------------------------------------------ #
# weight-sync wire schema
# ------------------------------------------------------------------ #
def pack_broadcast(
    weights: Any, done: bool, version: Optional[int] = None
) -> Dict[str, Any]:
    """Server -> client round broadcast. Sync senders pass no ``version``
    (payloads — and so the emulated wire bytes — are unchanged in sync
    mode)."""
    msg: Dict[str, Any] = {"weights": weights, "done": done}
    if version is not None:
        msg["version"] = version
    return msg


def pack_update(
    weights: Any, num_samples: int, version: Optional[int] = None
) -> Dict[str, Any]:
    """Client -> server model update. ``version`` echoes the server version
    the sender trained from; omitted when the sender never saw one."""
    msg: Dict[str, Any] = {"weights": weights, "num_samples": num_samples}
    if version is not None:
        msg["version"] = version
    return msg


class RoundProtocol:
    """What flows on ``channel`` per round step, bound to one role program.

    Subclasses implement the four step bodies the standard chains delegate
    to (trainer side: ``fetch``/``upload``; aggregator side:
    ``distribute``/``aggregate``) and may override ``rewrite_chain``. State
    kept on the instance is per-worker.
    """

    name: str = ""

    pack_broadcast = staticmethod(pack_broadcast)
    pack_update = staticmethod(pack_update)

    def __init__(self, role: Role, channel: Optional[str]) -> None:
        self.role = role
        self.channel = channel

    def _end(self):
        assert self.channel is not None, f"{self.name}: no protocol channel"
        return self.role.ctx.end(self.channel)

    # ----------------------- trainer-side steps ----------------------- #
    def fetch(self) -> None:
        raise NotImplementedError(f"protocol {self.name!r} defines no fetch step")

    def upload(self) -> None:
        raise NotImplementedError(f"protocol {self.name!r} defines no upload step")

    # ---------------------- aggregator-side steps --------------------- #
    def distribute(self) -> None:
        raise NotImplementedError(
            f"protocol {self.name!r} defines no distribute step"
        )

    def aggregate(self) -> None:
        raise NotImplementedError(
            f"protocol {self.name!r} defines no aggregate step"
        )

    # ------------------------- chain surgery -------------------------- #
    def rewrite_chain(self, composer: Composer) -> None:
        """Optional hook: reshape the composed chain via the Table 1 API.
        The default protocol leaves the chain untouched."""
        return None


class WeightSync(RoundProtocol):
    """The classic FL round protocol, step for step the JAX package's."""

    name = "weight-sync"

    # ----------------------- trainer-side steps ----------------------- #
    def fetch(self) -> None:
        role = self.role
        end = self._end()
        msg = end.recv(await_peer(role.ctx, end))
        role.weights = msg["weights"]
        role._server_version = msg.get("version", role._server_version)
        role._work_done = bool(msg.get("done", False))

    def upload(self) -> None:
        role = self.role
        if role._work_done:
            return
        end = self._end()
        # emulated local compute time, if the harness configured one
        role.ctx.advance_clock(
            self.channel, float(role.config.get("compute_time", 0.0))
        )
        end.send(
            await_peer(role.ctx, end),
            pack_update(role.weights, role.num_samples, role._server_version),
        )

    # ---------------------- aggregator-side steps --------------------- #
    def distribute(self) -> None:
        role = self.role
        if not role._work_done and int(role.config.get("reduce_plan", 0) or 0) > 0:
            raise NotImplementedError(
                "reduce_plan: the hub reduce plane (install_reduce) is not "
                "ported yet (ROADMAP Queue 1 item 6)"
            )
        end = self._end()
        end.send_many(end.ends(), pack_broadcast(role.weights, role._work_done))

    def aggregate(self) -> None:
        role = self.role
        if role._work_done:
            return  # peers were just told to exit; nothing will arrive
        end = self._end()
        acc = StreamingMean(device=role.ctx.device)
        # stream per source in sorted-src order: one update is in flight at
        # a time and the accumulation order is independent of arrival order
        for _, msg in end.recv_ordered(end.ends()):
            acc.fold(msg["weights"], float(msg.get("num_samples", 1)))
        role.peak_buffered = max(role.peak_buffered, acc.peak_buffered)
        role.metrics.append({
            "agg_folds": acc.count,
            "agg_frames": acc.count,
            "peak_buffered": role.peak_buffered,
        })
        mean, total = acc.finalize()
        if mean is not None:
            role.agg_weights = mean
            role.agg_samples = int(total)
            role.weights = role.agg_weights


# ------------------------------------------------------------------ #
# Vertical FL: feature-split parties <-> label-holding head
# ------------------------------------------------------------------ #
def _role_of(worker_id: str) -> str:
    return worker_id.rsplit("-", 1)[0]


def _vertical_config(config: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "samples": int(config.get("vertical_samples", 256)),
        "features": int(config.get("vertical_features", 32)),
        "classes": int(config.get("vertical_classes", 10)),
        "batch": int(config.get("vertical_batch", 32)),
        "steps": int(config.get("vertical_steps", 4)),
        "lr": np.float32(config.get("vertical_lr", 0.2)),
        "seed": int(config.get("vertical_seed", 0)),
    }


def _vertical_dataset(cfg: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
    """The shared sample rows of the vertical job, generated on the host from
    the job seed on every participant, with the JAX package's generator and
    arithmetic, so both packages see the same rows and labels: parties slice
    their feature columns out of ``x``, the head reads only the labels
    ``y``."""
    rng = np.random.default_rng(cfg["seed"])
    x = rng.normal(size=(cfg["samples"], cfg["features"])).astype(np.float32)
    w_true = rng.normal(size=(cfg["features"], cfg["classes"])).astype(np.float32)
    noise = 0.1 * rng.normal(size=(cfg["samples"], cfg["classes"]))
    y = np.argmax(x @ w_true + noise.astype(np.float32), axis=1)
    return x, y.astype(np.int64)


def _batch_indices(cfg: Dict[str, Any], rnd: int, step: int) -> np.ndarray:
    """Deterministic round-robin minibatch for (round, step): both sides of
    every activation/gradient exchange pick identical sample rows."""
    start = (rnd * cfg["steps"] + step) * cfg["batch"]
    return np.arange(start, start + cfg["batch"]) % cfg["samples"]


class VerticalSplit(RoundProtocol):
    """Feature-split (vertical) FL over one activation channel.

    Per round, per batch: each party sends its partial logits
    ``x_batch[:, cols_p] @ w_p`` to the head; the head folds the partial
    logits in sorted-party order, adds its bias, computes the softmax
    cross-entropy gradient against the labels only it holds, and returns the
    gradient; each party applies the chain-rule update to its own column
    block. Only activations and logit gradients cross the wire.

    The head runs the unchanged ``GlobalAggregator`` chain, the parties the
    unchanged ``Trainer`` chain. The rows move to the job's device once;
    products, softmax and SGD steps run there in float32, in the JAX
    package's order, with every scalar a 0-d float32 tensor (a CUDA
    ``tensor / python_float`` is a reciprocal multiply). The products round
    as the device's BLAS does, so the two packages agree within a float32
    tolerance, not bit for bit.
    """

    name = "vertical-split"

    def __init__(self, role: Role, channel: Optional[str]) -> None:
        super().__init__(role, channel)
        self.cfg = _vertical_config(role.config)
        self._round = 0
        self._x: Optional[torch.Tensor] = None  # party: my feature columns
        self._y: Optional[torch.Tensor] = None  # head: the labels
        self._losses: List[float] = []

    def _scalar(self, value: Any) -> torch.Tensor:
        return torch.tensor(float(value), dtype=torch.float32, device=self.role.ctx.device)

    def _batch(self, rnd: int, step: int) -> torch.Tensor:
        idx = _batch_indices(self.cfg, rnd, step)
        return torch.from_numpy(idx).to(self.role.ctx.device)

    # -------------------------- membership ---------------------------- #
    def _members(self) -> List[str]:
        assert self.channel is not None
        ctx = self.role.ctx
        members = ctx.static_members.get(self.channel)
        if not members:
            end = self._end()
            members = sorted(end.ends() + [ctx.worker.worker_id])
        return list(members)

    def _party_slice(self) -> Tuple[int, int]:
        """My contiguous feature-column block [lo, hi), split evenly (by
        rank order) over the parties of my role."""
        ctx = self.role.ctx
        me, my_role = ctx.worker.worker_id, ctx.worker.role
        parties = sorted(m for m in self._members() if _role_of(m) == my_role)
        rank, n = parties.index(me), len(parties)
        f = self.cfg["features"]
        return rank * f // n, (rank + 1) * f // n

    # ----------------------- party-side steps ------------------------- #
    def _party_data(self) -> torch.Tensor:
        if self._x is None:
            x, _ = _vertical_dataset(self.cfg)
            lo, hi = self._party_slice()
            dev = self.role.ctx.device
            self._x = torch.from_numpy(np.ascontiguousarray(x[:, lo:hi])).to(dev)
            if self.role.weights is None:
                self.role.weights = {
                    "w": torch.zeros((hi - lo, self.cfg["classes"]), dtype=torch.float32,
                                     device=dev)
                }
        return self._x

    def fetch(self) -> None:
        """Round marker from the head: carries the round index and the done
        flag, never model weights."""
        role = self.role
        end = self._end()
        msg = end.recv(await_peer(role.ctx, end))
        self._round = int(msg.get("round", self._round))
        role._work_done = bool(msg.get("done", False))

    def upload(self) -> None:
        """One round of per-batch activation/gradient exchange."""
        role = self.role
        if role._work_done:
            return
        x = self._party_data()
        end = self._end()
        head = await_peer(role.ctx, end)
        role.ctx.advance_clock(
            self.channel, float(role.config.get("compute_time", 0.0))
        )
        lr = self._scalar(self.cfg["lr"])
        w = torch.as_tensor(role.weights["w"], dtype=torch.float32, device=role.ctx.device)
        for step in range(self.cfg["steps"]):
            xb = x[self._batch(self._round, step)]
            end.send(head, {"activation": xb @ w, "step": step})
            grad = end.recv(head)["grad"].to(torch.float32)
            w = w - lr * (xb.T @ grad)
        role.weights = {"w": w}

    # ------------------------ head-side steps ------------------------- #
    def _head_data(self) -> torch.Tensor:
        if self._y is None:
            _, y = _vertical_dataset(self.cfg)
            self._y = torch.from_numpy(y).to(self.role.ctx.device)
            if not isinstance(self.role.weights, dict) or "b" not in (
                self.role.weights or {}
            ):
                self.role.weights = {
                    "b": torch.zeros(self.cfg["classes"], dtype=torch.float32,
                                     device=self.role.ctx.device)
                }
        return self._y

    def distribute(self) -> None:
        role = self.role
        end = self._end()
        end.broadcast({"round": role._round, "done": role._work_done})

    def aggregate(self) -> None:
        role = self.role
        if role._work_done:
            return
        y = self._head_data()
        end = self._end()
        parties = sorted(end.ends())
        cfg = self.cfg
        dev = role.ctx.device
        lr, batch, tiny = self._scalar(cfg["lr"]), self._scalar(cfg["batch"]), self._scalar(1e-12)
        b = torch.as_tensor(role.weights["b"], dtype=torch.float32, device=dev)
        losses = []
        eye = torch.eye(cfg["classes"], dtype=torch.float32, device=dev)
        for step in range(cfg["steps"]):
            idx = self._batch(role._round, step)
            # fold partial logits in sorted-party order: the accumulation
            # order is fixed, so head-side numerics are deployment-invariant
            z: Optional[torch.Tensor] = None
            for p in parties:
                a = end.recv(p)["activation"].to(torch.float32)
                z = a if z is None else z + a
            assert z is not None, "vertical head has no parties"
            z = z + b
            z = z - z.max(dim=1, keepdim=True).values
            e = torch.exp(z)
            probs = e / e.sum(dim=1, keepdim=True)
            yb = y[idx]
            grad = (probs - eye[yb]) / batch
            # identical grad frame per party: one fan-out
            end.send_many(parties, {"grad": grad, "step": step})
            b = b - lr * grad.sum(dim=0)
            picked = probs[torch.arange(len(yb), device=dev), yb]
            losses.append(float(-torch.log(picked + tiny).mean()))
        role.weights = {"b": b}
        role.agg_samples = cfg["batch"] * cfg["steps"]
        loss = float(np.mean(losses))
        self._losses.append(loss)
        role.metrics.append({"vertical_loss": loss, "vertical_round": role._round})


# ------------------------------------------------------------------ #
# Gossip: serverless neighbour averaging on a ring
# ------------------------------------------------------------------ #
class GossipAvg(RoundProtocol):
    """Ring-neighbour weighted averaging, no aggregator anywhere.

    Each round every trainer trains locally, then exchanges its model with
    its two ring neighbours (by rank in the static membership) and replaces
    it with the sample-weighted mean of its own and the neighbours' models,
    folded in sorted worker-id order (``_fold_allreduce``, float64 on the
    job's device), so seeded jobs are byte-identical on every backend.

    Applied to the stock ``Trainer`` chain by chain surgery: ``fetch`` is
    removed and ``upload`` is replaced by a ``gossip`` tasklet.
    """

    name = "gossip-avg"

    def rewrite_chain(self, composer: Composer) -> None:
        role = self.role
        for anchor in ("fetch", "upload"):
            if not composer.has_tasklet(anchor):
                raise ComposerError(
                    f"gossip-avg expects a Trainer-style chain with a "
                    f"{anchor!r} tasklet; got {composer.chain.aliases() if composer.chain else []}"
                )
        # serverless: nobody hands out initial weights; start from the
        # job's init_weights like DistributedTrainer does
        if role.weights is None:
            role.weights = tree_from_numpy(role.config.get("init_weights"), role.ctx.device)
        tl = Tasklet("gossip", self.gossip)
        composer.get_tasklet("fetch").remove()
        composer.get_tasklet("upload").replace_with(tl)

    def _neighbors(self) -> List[str]:
        ctx = self.role.ctx
        me = ctx.worker.worker_id
        end = self._end()
        members = ctx.static_members.get(self.channel) or sorted(
            end.ends() + [me]
        )
        rank, n = members.index(me), len(members)
        return sorted({members[(rank - 1) % n], members[(rank + 1) % n]} - {me})

    def gossip(self) -> None:
        role = self.role
        ctx = role.ctx
        end = self._end()
        ctx.advance_clock(
            self.channel, float(role.config.get("compute_time", 0.0))
        )
        update = pack_update(role.weights, role.num_samples)
        neighbors = self._neighbors()
        # sorted sends (one fan-out), then sorted per-src drains:
        # deterministic regardless of arrival order
        end.send_many(neighbors, update)
        received = [(nb, end.recv(nb)) for nb in neighbors]
        role.weights, _ = _fold_allreduce(
            end.me, role.weights, float(role.num_samples), received, ctx.device
        )
        role._round += 1
        role.metrics.append({"round": role._round})
        if role._round >= role.rounds:
            role._work_done = True


# ------------------------------------------------------------------ #
# registry
# ------------------------------------------------------------------ #
ProtocolFactory = Callable[[Role, Optional[str]], RoundProtocol]

PROTOCOLS: Dict[str, ProtocolFactory] = {}


def register_protocol(
    name: str, factory: ProtocolFactory, *, overwrite: bool = False
) -> ProtocolFactory:
    """Register a round protocol under ``name`` (a ``RoundProtocol``
    subclass, or any ``(role, channel) -> RoundProtocol`` factory)."""
    if not overwrite and name in PROTOCOLS and PROTOCOLS[name] is not factory:
        raise ValueError(
            f"round protocol {name!r} already registered; pass overwrite=True "
            "to replace it"
        )
    PROTOCOLS[name] = factory
    return factory


def registered_protocols() -> List[str]:
    return sorted(PROTOCOLS)


def make_protocol(name: str, role: Role, channel: Optional[str]) -> RoundProtocol:
    try:
        factory = PROTOCOLS[name]
    except KeyError:
        raise KeyError(
            f"unknown round protocol {name!r}; registered: {registered_protocols()}"
        ) from None
    return factory(role, channel)


register_protocol(WeightSync.name, WeightSync)
register_protocol(VerticalSplit.name, VerticalSplit)
register_protocol(GossipAvg.name, GossipAvg)
