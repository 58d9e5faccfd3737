"""PyTorch + CUDA port of the Flame reproduction, beside the JAX package.

Mirrors ``repro``'s layout (``core/``, ``data/``, ``kernels/agg/``,
``transport/``) so each module's counterpart has the same name. It imports
torch and numpy, never jax and never ``repro``. Payload leaves are
``torch.Tensor``s on the job's device; ``repro_torch.core.runtime.run_job``
runs on CUDA unless the caller passes ``device="cpu"``.
"""
