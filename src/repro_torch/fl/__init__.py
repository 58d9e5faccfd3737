"""Federated-learning helpers of the port (``repro.fl``): the server
strategies, the channel payload compression behind the wire codecs,
differential privacy and the federated train step (``fedstep``)."""
from repro_torch.fl.privacy import DPConfig, clip_and_noise
from repro_torch.fl.strategies import (
    FedAdagrad,
    FedAdam,
    FedAsync,
    FedAvg,
    FedBuff,
    FedDyn,
    FedProx,
    FedYogi,
    ServerStrategy,
    get_strategy,
    register_strategy,
    registered_strategies,
)

__all__ = [
    "DPConfig",
    "clip_and_noise",
    "ServerStrategy",
    "FedAvg",
    "FedProx",
    "FedAdam",
    "FedAdagrad",
    "FedYogi",
    "FedDyn",
    "FedBuff",
    "FedAsync",
    "get_strategy",
    "register_strategy",
    "registered_strategies",
]
