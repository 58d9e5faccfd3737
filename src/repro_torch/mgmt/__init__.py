"""The management plane of the port (``repro.mgmt``): apiserver, controller,
deployers, agents and notifier, in ``repro_torch.mgmt.plane``."""
from repro_torch.mgmt.plane import (
    Agent,
    APIServer,
    Controller,
    Deployer,
    InprocDeployer,
    JobState,
    Notifier,
)

__all__ = [
    "APIServer",
    "Agent",
    "Controller",
    "Deployer",
    "InprocDeployer",
    "JobState",
    "Notifier",
]
