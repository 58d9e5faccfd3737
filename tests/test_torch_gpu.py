"""The port's CUDA kernels and a job on the card (``gpu`` marker).

These need a CUDA device and skip without one; they import neither jax nor
the JAX package, so they run on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain version on the same CUDA tensors:
bytes equal for the exact entries and the quant kernels, and for the fused
weighted sum within 1e-6 of the summed magnitudes of its terms (it may
contract into FMAs); the flash kernel within atol 2e-5 (float32) and 3e-2
(bfloat16), the JAX package's tolerances, as it sums in another order.
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
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.quant import kernel as qkernel
from repro_torch.kernels.quant import ops as qops
from repro_torch.kernels.quant import ref as qref


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


def _same_bytes(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [1, 3, 1000])
def test_quant_kernels_match_plain_versions(cuda_device, nb):
    gen = torch.Generator(device=cuda_device).manual_seed(nb)
    scale = torch.exp(torch.randn(nb, 1, generator=gen, device=cuda_device) * 4)
    x = torch.randn(nb, qkernel.BLOCK, generator=gen, device=cuda_device) * scale
    x[0, :7] = -0.0
    x[-1, 3] = 3e38
    q, s = qkernel.quantize_blocks(x)
    pq, ps = qref.quantize_blocks(x)
    assert _same_bytes(q, pq) and _same_bytes(s, ps)
    assert _same_bytes(qkernel.dequantize_blocks(q, s), qref.dequantize_blocks(pq, ps))
    # the card's bits are the CPU plain version's
    cq, cs = qref.quantize_blocks(x.cpu())
    assert _same_bytes(q.cpu(), cq) and _same_bytes(s.cpu(), cs)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_quant_kernel_edge_blocks(cuda_device):
    x = torch.zeros(5, qkernel.BLOCK, device=cuda_device)
    x[1] = -0.0
    x[2] = torch.arange(qkernel.BLOCK, device=cuda_device) % 254 - 126.5  # ties, scale 1
    x[2, 0] = 127.0
    x[3, 11] = float("nan")
    x[4, 2] = float("inf")
    q, s = qkernel.quantize_blocks(x)
    pq, ps = qref.quantize_blocks(x)
    assert _same_bytes(q[:3], pq[:3]) and _same_bytes(s[:3], ps[:3])
    assert float(s[2]) == 1.0 and torch.equal(q[2].float(), torch.round(x[2]))
    assert bool(torch.isnan(s[3])) and float(s[4]) == float("inf")
    # flat layer: padding of a tail block
    flat = torch.randn(2 * qkernel.BLOCK + 99, device=cuda_device)
    fq, fs = qops.quantize_flat(flat)
    assert fq.shape == (3, qkernel.BLOCK)
    back = qops.dequantize_flat(fq, fs, flat.numel())
    assert _same_bytes(back, qref.dequantize_blocks(*qref.quantize_blocks(
        torch.cat([flat, flat.new_zeros(qkernel.BLOCK - 99)]).view(3, -1))).view(-1)[:flat.numel()])
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_codec_job_on_card_equals_cpu(cuda_device):
    """The int8_blocks loopback job on the card gives the CPU run's bytes,
    through the quant kernels (one quantize per encode, one dequantize per
    decode)."""
    import dataclasses

    rng = np.random.default_rng(1)
    w0 = {"w": rng.normal(size=(96, 129)).astype(np.float32),
          "b": rng.normal(size=(129,)).astype(np.float32)}
    tag = classical_fl()
    tag = dataclasses.replace(tag, channels=tuple(
        dataclasses.replace(c, backend="multiproc", codec="int8_blocks") for c in tag.channels))
    out = {}
    for dev in (cuda_device, "cpu"):
        job = JobSpec(tag=tag, datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(3)),
                      hyperparams={"rounds": 2, "init_weights": w0})
        qkernel.reset_launches()
        res = run_job(job, device=dev, timeout=120,
                      program_overrides={"trainer": AddOneTrainer})
        assert not res.errors, res.errors
        out[str(dev)] = (tree_to_numpy(res.global_weights()), res.channel_stats,
                         qkernel.quantize_blocks.launches, qkernel.dequantize_blocks.launches)
    (card, card_stats, nq, nd), (host, host_stats, hq, hd) = out.values()
    assert all(card[k].tobytes() == host[k].tobytes() for k in card)
    assert card_stats == host_stats
    stats = card_stats["param-channel"]
    assert (nq, nd) == (stats["payload_encodes"], stats["payload_decodes"]) and (hq, hd) == (0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window,dtype", [
    (2, 128, 4, 2, 64, True, 0, torch.float32),     # GQA
    (1, 256, 4, 4, 32, True, 0, torch.float32),     # MHA
    (2, 192, 8, 1, 64, True, 64, torch.float32),    # MQA + sliding window
    (1, 128, 4, 2, 64, False, 0, torch.float32),    # bidirectional
    (1, 200, 2, 2, 32, True, 0, torch.float32),     # ragged
    (1, 128, 4, 2, 64, True, 0, torch.bfloat16),
    (2, 300, 8, 2, 128, True, 0, torch.bfloat16),   # Qwen's head dim, ragged
    (1, 257, 4, 2, 256, True, 0, torch.float32),    # Gemma's head dim
    (1, 97, 2, 1, 32, False, 40, torch.float32),    # non-causal window
])
def test_flash_kernel_matches_plain_version(cuda_device, B, S, H, Hkv, D, causal, window, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(S + D)
    q = torch.randn(B, S, H, D, generator=gen, device=cuda_device).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen, device=cuda_device).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=cuda_device).to(dtype)
    fkernel.reset_launches()
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert fkernel.flash_attention_bhsd.launches == 1
    assert out.dtype == dtype and out.shape == q.shape
    plain = fref.reference_attention(q, k, v, causal=causal, window=window)
    atol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), plain.float(), atol=atol, rtol=0)
    # and a limit scaled to the output: relative L2 within a few times the
    # output's rounding, which a wrong tile would exceed
    rel_l2 = 1e-5 if dtype == torch.float32 else 5e-3
    diff = (out.double() - plain.double()).norm() / plain.double().norm()
    assert diff <= rel_l2, f"relative L2 {float(diff)} > {rel_l2}"
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    q = torch.randn(1, 16, 2, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q)
    q = torch.randn(1, 2, 16, 64, device=cuda_device)
    v = torch.randn(1, 2, 64, 16, device=cuda_device).transpose(2, 3)  # last stride 16
    with pytest.raises(ValueError, match="contiguous"):
        fkernel.flash_attention_bhsd(q, q, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fkernel.flash_attention_bhsd(q.half(), q.half(), q.half())


@pytest.mark.gpu
def test_serving_on_card_launches_flash_once_per_layer(cuda_device):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_config("qwen2_5_3b", reduced=True), attn_impl="flash")
    bundle = build_model(cfg, cuda_device)
    params = bundle.init(torch.Generator(device=cuda_device).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device)
    fkernel.reset_launches()
    out = generate(bundle, params, prompts, 4)
    assert fkernel.flash_attention_bhsd.launches == cfg.num_layers
    assert out.all_finite and out.tokens.shape == (2, 4)
