"""Federated-learning helpers of the port (``repro.fl``): the server
strategies, the channel payload compression behind the wire codecs,
differential privacy, client and sample selection and the federated train
step (``fedstep``)."""
from repro_torch.fl.privacy import DPConfig, clip_and_noise
from repro_torch.fl.sampling import FedBalancerSampler, SelectAllSampler
from repro_torch.fl.selection import (
    DeadlineAwareSelector,
    OortSelector,
    RandomSelector,
    SelectAll,
    get_selector,
)
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
    "SelectAll",
    "RandomSelector",
    "OortSelector",
    "DeadlineAwareSelector",
    "get_selector",
    "SelectAllSampler",
    "FedBalancerSampler",
]
