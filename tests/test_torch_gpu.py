"""The port's CUDA kernels and a job on the card (``gpu`` marker).

These need a CUDA device and skip without one; they import neither jax nor
the JAX package, so they run on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain version on the same CUDA tensors:
bytes equal for the exact entries, and for the fused weighted sum within
1e-6 of the summed magnitudes of its terms (it may contract into FMAs).
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import tree_to_numpy
from repro_torch.core.expansion import JobSpec
from repro_torch.core.roles import Trainer
from repro_torch.core.runtime import run_job
from repro_torch.core.tag import DatasetSpec
from repro_torch.core.topologies import classical_fl
from repro_torch.kernels.agg import kernel, ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_kernels_match_plain_versions(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for C, N in [(1, 1), (3, 7), (7, 130), (12, 16_640), (2, (1 << 20) + 3)]:
        d = torch.randn(C, N, generator=gen, device=cuda_device).to(dtype)
        d[:, 0] = -0.0
        w = torch.rand(C, generator=gen, device=cuda_device) * 30 + 1
        den = torch.tensor([float(w.sum())], device=cuda_device)
        out = kernel.exact_fold(d, w, den)
        assert torch.equal(_bits(out), _bits(ref.exact_fold(d, w, den)))
        fast = kernel.weighted_aggregate(d, w, den)
        bound = 1e-6 * (w[:, None] * d.float()).abs().sum(0) / den
        assert ((fast - ref.weighted_aggregate(d, w, den)).abs() <= bound).all()
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_streaming_entries_match_plain_versions(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    for N in (1, 7, 130, 16_640, (1 << 20) + 3):
        a, b = (torch.randn(N, generator=gen, device=cuda_device) for _ in range(2))
        acc = kernel.exact_fold_into(None, a, 3.0)
        acc = kernel.exact_fold_into(acc, b, 0.5)
        plain = ref.exact_fold_into(ref.exact_fold_into(None, a, 3.0), b, 0.5)
        assert torch.equal(_bits(acc), _bits(plain))
        q = kernel.exact_divide(acc, 7.7)
        assert torch.equal(_bits(q), _bits(ref.exact_divide(acc, 7.7)))
    torch.cuda.synchronize()


class AddOneTrainer(Trainer):
    def train(self):
        if self.weights is not None:
            self.weights = {k: v + 1.0 for k, v in self.weights.items()}


@pytest.mark.gpu
def test_classical_job_on_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(0)
    w0 = {"w": rng.normal(size=(64, 33)).astype(np.float32),
          "b": rng.normal(size=(33,)).astype(np.float32)}
    out = {}
    for dev in (cuda_device, "cpu"):
        job = JobSpec(tag=classical_fl(),
                      datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(4)),
                      hyperparams={"rounds": 2, "init_weights": w0})
        kernel.reset_launches()
        res = run_job(job, device=dev, timeout=60,
                      program_overrides={"trainer": AddOneTrainer})
        assert not res.errors, res.errors
        out[str(dev)] = (tree_to_numpy(res.global_weights()), res.channel_bytes,
                         kernel.exact_fold_into.launches)
    (card, card_bytes, launches), (host, host_bytes, host_launches) = out.values()
    assert all(card[k].tobytes() == host[k].tobytes() for k in card)
    assert card_bytes == host_bytes
    assert launches > 0 and host_launches == 0
