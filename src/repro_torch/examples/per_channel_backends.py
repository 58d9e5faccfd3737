"""Per-channel backend selection (§6.2) on the mesh path.

The same TAG, lowered with two different cross-pod channel wire policies,
produces train steps whose collective traffic differs: the per-channel
``backend``/``wire_dtype`` attribute is the knob. Runs a least-squares
model over a one-client ``data`` mesh and shows both steps converge while
the int8 uplink moves ~4x fewer wire bytes.

The JAX script draws its inputs with ``jax.random.normal(key(0), (16, 3))``,
which the port cannot reproduce without jax; this one draws them from
``numpy.random.default_rng(0)`` instead, so its losses are not the script's.

Run:  PYTHONPATH=src python -m repro_torch.examples.per_channel_backends [--device cpu]
"""
import numpy as np
import torch

from repro_torch.convert import resolve_device
from repro_torch.core.mesh_lowering import Mesh, lower_tag_to_mesh
from repro_torch.core.topologies import hierarchical_fl
from repro_torch.examples import cli
from repro_torch.fl.fedstep import FedStepConfig, init_server_state, make_fl_train_step
from repro_torch.fl.strategies import get_strategy

MESH = Mesh((("data", 1),))
WIRES = ("f32", "int8")
STEPS = 30


def build(wire):
    tag = hierarchical_fl(param_wire_dtype="f32", agg_wire_dtype=wire)
    plan = lower_tag_to_mesh(tag, ("data",))
    strat = get_strategy("fedavg")

    def loss_fn(p, batch, gen):
        return torch.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)

    step = make_fl_train_step(loss_fn, strat, plan, MESH,
                              FedStepConfig(local_steps=2, local_lr=0.05))
    return step, strat, plan


def batch() -> dict:
    """The regression batch, drawn on the host: 16 rows of 3 features."""
    w_true = np.array([[1.0], [-2.0], [0.5]], np.float32)
    x = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
    return {"x": x, "y": x @ w_true}


def train(wire: str, data: dict) -> dict:
    """``STEPS`` rounds of the step lowered with ``wire`` on the cross-pod
    channel, from zero weights on ``data``'s device: every round's loss
    and the final weights."""
    step, strat, plan = build(wire)
    params = {"w": torch.zeros((3, 1), device=data["x"].device)}
    state = init_server_state(strat, plan, params)
    losses = []
    for i in range(STEPS):
        params, state, m = step(params, state, data, i)
        losses.append(float(m["loss"]))
    return {"losses": losses, "w": params["w"].cpu().numpy()}


def main(device=None) -> dict:
    dev = resolve_device(device)
    data = {k: torch.from_numpy(v).to(dev) for k, v in batch().items()}
    out = {}
    for wire in WIRES:
        out[wire] = run = train(wire, data)
        loss = run["losses"][-1]
        print(f"wire={wire}: final loss {loss:.5f}  "
              f"w={np.round(run['w'].ravel(), 3)}")
        assert loss < 0.05
    print("per_channel_backends OK — same TAG, different channel policy, "
          "both converge (int8 moves 4x fewer wire bytes per element)")
    return out


if __name__ == "__main__":
    cli(main)
