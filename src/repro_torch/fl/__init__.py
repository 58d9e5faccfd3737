"""Federated-learning helpers of the port (``repro.fl``): the server
strategies and the channel payload compression behind the wire codecs."""
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
