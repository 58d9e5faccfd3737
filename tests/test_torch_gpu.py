"""The port's CUDA kernels and a job on the card (``gpu`` marker).

These need a CUDA device and skip without one; they import neither jax nor
the JAX package, so they run on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain version on the same CUDA tensors:
bytes equal for the exact entries and the quant kernels, and for the fused
weighted sum within 1e-6 of the summed magnitudes of its terms (it may
contract into FMAs); the flash kernels within atol 2e-5 (float32) and 3e-2
(bfloat16), the JAX package's tolerances, as they sum in another order.
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


def _leaves_at(sizes, gen, dev, offset_every=2):
    """Leaves of ``sizes`` in one buffer on ``dev``; every ``offset_every``-th
    starts one float past a 16-byte boundary."""
    pos, spans = 0, []
    for i, n in enumerate(sizes):
        pos += -pos % 4 + (i % offset_every == 1)
        spans.append((pos, n))
        pos += n
    buf = torch.randn(pos + 4, generator=gen, device=dev)
    return [buf[o:o + n] for o, n in spans]


@pytest.mark.gpu
@pytest.mark.parametrize("many", [False, True])
def test_tree_fold_matches_plain_version(cuda_device, many):
    """The tree entry against its plain version, first and later updates,
    update and accumulator leaves at 16-byte and 4-byte offsets, on a tree
    of odd sizes and on one of more than TREE_LEAVES leaves."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    K = kernel.TREE_LEAVES
    sizes = [int(n) for n in torch.randint(1, 3000, (2 * K + 7,), generator=torch.Generator().manual_seed(4))] \
        if many else [0, 1, 3, 4, 5, 4099, kernel.CHUNK + 3, (1 << 20) + 3]
    ds, ds2 = _leaves_at(sizes, gen, cuda_device), _leaves_at(sizes, gen, cuda_device, 3)
    kernel.reset_launches()
    acc = kernel.exact_fold_into_tree(None, ds, 3.0)
    plain = ref.exact_fold_into_tree(None, ds, 3.0)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(acc, plain))
    # later updates into accumulators of both alignments
    for accs in (acc, _leaves_at(sizes, gen, cuda_device, 2)):
        for a, b in zip(accs, plain):
            a.copy_(b)
        want = ref.exact_fold_into_tree([a.clone() for a in accs], ds2, 0.3)
        out = kernel.exact_fold_into_tree(accs, ds2, 0.3)
        assert all(o is a for o, a in zip(out, accs))
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(out, want))
    nonempty = sum(1 for n in sizes if n)
    assert kernel.exact_fold_into_tree.launches == 3 * -(-nonempty // K)
    assert kernel.exact_fold_into.launches == 0
    with pytest.raises(ValueError, match="overlaps"):
        kernel.exact_fold_into_tree([acc[1], acc[3]], [ds[1], acc[3]], 1.0)
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
                         kernel.exact_fold_into_tree.launches, kernel.exact_fold_into.launches)
    (card, card_bytes, launches, per_leaf), (host, host_bytes, host_launches, _) = out.values()
    assert all(card[k].tobytes() == host[k].tobytes() for k in card)
    assert card_bytes == host_bytes
    # one tree launch per update (4 trainers, 2 rounds), none per leaf
    assert launches == 8 and per_leaf == 0 and host_launches == 0


class NoiseTrainerMixin:
    """Adds seeded noise drawn on the host (the same on every device) and
    reports ``3 + dataset index`` samples."""

    def train(self):
        if self.weights is None:
            return
        self._step = getattr(self, "_step", 0) + 1
        ds = self.ctx.worker.dataset
        self.num_samples = 3 + int(ds[1:])
        rng = np.random.default_rng(1000 * int(ds[1:]) + self._step)
        self.weights = {
            k: v + torch.from_numpy(
                (0.01 * rng.standard_normal(tuple(v.shape))).astype(np.float32)).to(v.device)
            for k, v in self.weights.items()}


def _topology_on_card_and_cpu(cuda_device, tag, trainer, n, rounds):
    rng = np.random.default_rng(1)
    w0 = {"w": rng.normal(size=(64, 33)).astype(np.float32),
          "b": rng.normal(size=(33,)).astype(np.float32)}
    out = []
    for dev in (cuda_device, "cpu"):
        job = JobSpec(tag=tag, datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(n)),
                      hyperparams={"rounds": rounds, "init_weights": w0})
        kernel.reset_launches()
        res = run_job(job, device=dev, timeout=60, program_overrides={"trainer": trainer})
        assert not res.errors, res.errors
        weights = {wid: tree_to_numpy(p.weights) for wid, p in res.programs.items()
                   if getattr(p, "weights", None) is not None}
        out.append((weights, res.channel_bytes,
                    {fn.__name__: fn.launches for fn in kernel.KERNELS}))
    (card, card_bytes, launches), (host, host_bytes, host_launches) = out
    assert card.keys() == host.keys()
    for wid in card:
        assert all(card[wid][k].tobytes() == host[wid][k].tobytes() for k in card[wid]), wid
    assert card_bytes == host_bytes
    assert not any(host_launches.values())
    return launches


@pytest.mark.gpu
def test_coordinated_job_on_card_equals_cpu(cuda_device):
    """2 aggregators and the global one each fold their sources with one
    stacked exact fold per leaf per round: 3 x 2 leaves x 3 rounds."""
    from repro_torch.core.roles_coord import CoordTrainer
    from repro_torch.core.topologies import coordinated_fl

    tag = coordinated_fl(dataset_groups={"default": tuple(f"d{i}" for i in range(6))})
    trainer = type("NoiseCoordTrainer", (NoiseTrainerMixin, CoordTrainer), {})
    launches = _topology_on_card_and_cpu(cuda_device, tag, trainer, 6, 3)
    assert launches["exact_fold"] == 3 * 2 * 3
    assert launches["exact_fold_into_tree"] == 0 and launches["weighted_aggregate"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("template", ["distributed", "hybrid", "gossip"])
def test_allreduce_topologies_on_card_equal_cpu(cuda_device, template):
    from repro_torch.core import roles
    from repro_torch.core.topologies import get_template

    if template == "hybrid":
        from repro_torch.core.topologies import hybrid_fl

        tag = hybrid_fl(groups=("c0", "c1"),
                        dataset_groups={"c0": ("d0", "d1"), "c1": ("d2", "d3")})
        base = roles.HybridTrainer
    else:
        tag = get_template(template)()
        base = roles.DistributedTrainer if template == "distributed" else Trainer
    trainer = type("NoiseTrainer", (NoiseTrainerMixin, base), {})
    launches = _topology_on_card_and_cpu(cuda_device, tag, trainer, 4, 2)
    # only hybrid's global aggregator folds on the kernels (one tree launch
    # per cluster leader's update); the all-reduces fold in float64 torch
    assert launches["exact_fold_into_tree"] == (4 if template == "hybrid" else 0)


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
    # the tensor-core kernel's shapes (bf16, D 64 and 128); flash.cu takes them too
    (2, 192, 8, 1, 64, True, 64, torch.bfloat16),   # MQA + sliding window
    (1, 97, 2, 1, 64, False, 40, torch.bfloat16),   # non-causal window, ragged
    (1, 256, 4, 4, 128, False, 0, torch.bfloat16),  # bidirectional
    (1, 400, 4, 1, 128, True, 100, torch.bfloat16),  # window rows with wholly masked first tiles
    (1, 512, 8, 1, 128, True, 0, torch.bfloat16),   # GQA 8:1
    # flash.cu only: bf16 at the head dim no tensor-core kernel takes
    (1, 200, 2, 2, 32, True, 0, torch.bfloat16),
    # the D 256 tensor-core kernel (Gemma's head dim); flash.cu takes them too
    (1, 257, 4, 2, 256, True, 0, torch.bfloat16),   # ragged, GQA
    (2, 384, 8, 8, 256, True, 0, torch.bfloat16),   # MHA, three q tiles
    (1, 300, 8, 1, 256, False, 0, torch.bfloat16),  # bidirectional, GQA 8:1
    (1, 400, 4, 2, 256, True, 100, torch.bfloat16),  # window rows with wholly masked first tiles
])
def test_flash_kernel_matches_plain_version(cuda_device, B, S, H, Hkv, D, causal, window, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(S + D)
    q = torch.randn(B, S, H, D, generator=gen, device=cuda_device).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen, device=cuda_device).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=gen, device=cuda_device).to(dtype)
    route = fkernel.route_of(dtype, D)
    assert route == ("flash_forward" if dtype == torch.float32 or D == 32 else
                     "flash_forward_sm90_d256" if D == 256 else "flash_forward_sm90")
    fkernel.reset_launches()
    outs = {route: flash_attention(q, k, v, causal=causal, window=window)}
    assert fkernel.flash_attention_bhsd.launches == 1
    assert {name: fn.launches for name, fn in fkernel.ROUTES.items()} == {
        name: int(name == route) for name in fkernel.ROUTES}
    if route != "flash_forward":  # flash.cu takes the tensor-core routes' inputs too
        outs["flash_forward"] = fkernel.flash_forward(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window).transpose(1, 2)
    plain = fref.reference_attention(q, k, v, causal=causal, window=window)
    atol = 2e-5 if dtype == torch.float32 else 3e-2
    # and a limit scaled to the output: relative L2 within a few times the
    # output's rounding, which a wrong tile would exceed
    rel_l2 = 1e-5 if dtype == torch.float32 else 5e-3
    for name, out in outs.items():
        assert out.dtype == dtype and out.shape == q.shape, name
        torch.testing.assert_close(out.float(), plain.float(), atol=atol, rtol=0, msg=name)
        diff = (out.double() - plain.double()).norm() / plain.double().norm()
        assert diff <= rel_l2, f"{name}: relative L2 {float(diff)} > {rel_l2}"
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("Sq,Skv,causal", [(100, 300, False), (100, 300, True), (300, 130, True)])
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128), (torch.bfloat16, 64),
                                     (torch.bfloat16, 256), (torch.float32, 128)])
def test_flash_kernels_with_other_key_lengths(cuda_device, Sq, Skv, causal, dtype, D):
    """Queries and keys of different lengths, on the route the wrapper
    picks and, for the tensor-core kernel's inputs, on flash.cu too."""
    gen = torch.Generator(device=cuda_device).manual_seed(Sq + Skv)
    q = torch.randn(1, Sq, 4, D, generator=gen, device=cuda_device).to(dtype)
    k = torch.randn(1, Skv, 2, D, generator=gen, device=cuda_device).to(dtype)
    v = torch.randn(1, Skv, 2, D, generator=gen, device=cuda_device).to(dtype)
    plain = fref.reference_attention(q, k, v, causal=causal)
    outs = [flash_attention(q, k, v, causal=causal)]
    if fkernel.route_of(dtype, D) != "flash_forward":
        outs.append(fkernel.flash_forward(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                          causal=causal).transpose(1, 2))
    atol, rel_l2 = (2e-5, 1e-5) if dtype == torch.float32 else (3e-2, 5e-3)
    for out in outs:
        torch.testing.assert_close(out.float(), plain.float(), atol=atol, rtol=0)
        assert (out.double() - plain.double()).norm() / plain.double().norm() <= rel_l2
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
    # a bf16 D-128 tensor that TMA cannot read raises; nothing reroutes it
    fkernel.reset_launches()
    good = torch.randn(1, 16, 2, 128, device=cuda_device).bfloat16().transpose(1, 2)
    shifted = torch.randn(1 + 16 * 2 * 128, device=cuda_device).bfloat16()[1:].view(
        1, 16, 2, 128).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fkernel.flash_attention_bhsd(shifted, good, good)
    with pytest.raises(ValueError, match="tensor-core kernel takes bfloat16"):
        fkernel.flash_forward_sm90(good.float(), good.float(), good.float())
    # and the same at D 256
    good = torch.randn(1, 16, 2, 256, device=cuda_device).bfloat16().transpose(1, 2)
    shifted = torch.randn(1 + 16 * 2 * 256, device=cuda_device).bfloat16()[1:].view(
        1, 16, 2, 256).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        fkernel.flash_attention_bhsd(good, shifted, good)
    with pytest.raises(ValueError, match="tensor-core kernel takes bfloat16"):
        fkernel.flash_forward_sm90_d256(good[..., :128], good[..., :128], good[..., :128])
    assert [fn.launches for fn in fkernel.KERNELS] == [0, 0, 0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,head_dim,route", [
    ("float32", None, "flash_forward"),              # the reduced config: f32, D 32
    ("bfloat16", 128, "flash_forward_sm90"),         # the full model's dtype and head dim
])
def test_serving_on_card_launches_flash_once_per_layer(cuda_device, dtype, head_dim, route):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model

    cfg = get_config("qwen2_5_3b", reduced=True)
    cfg = dataclasses.replace(cfg, attn_impl="flash", param_dtype=dtype,
                              head_dim=head_dim or cfg.head_dim)
    bundle = build_model(cfg, cuda_device)
    params = bundle.init(torch.Generator(device=cuda_device).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device)
    fkernel.reset_launches()
    out = generate(bundle, params, prompts, 4)
    assert fkernel.flash_attention_bhsd.launches == cfg.num_layers
    assert {name: fn.launches for name, fn in fkernel.ROUTES.items()} == {
        name: cfg.num_layers * (name == route) for name in fkernel.ROUTES}
    assert out.all_finite and out.tokens.shape == (2, 4)


@pytest.mark.gpu
def test_moe_layer_on_card_equals_cpu(cuda_device):
    """The reduced Qwen3-MoE's MoE layer (float32, TF32 off) on the card
    against the CPU, and its gradient: within 1e-5 (float32 products summed
    in other orders; the same routing)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("qwen3_moe_235b_a22b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, cfg, torch.float32)
    x = torch.randn(2, 64, cfg.d_model, generator=gen)
    out = []
    for dev in ("cpu", cuda_device):
        pd = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev))
              for k, v in p.items()}
        xd = x.to(dev).requires_grad_(True)
        y, aux = moe.moe_apply(pd, xd, cfg)
        (gx,) = torch.autograd.grad((y * y).sum() + aux, xd)
        out.append((y.detach().cpu(), float(aux), gx.cpu()))
    (y0, a0, g0), (y1, a1, g1) = out
    assert torch.allclose(y0, y1, atol=1e-5, rtol=0) and abs(a0 - a1) <= 1e-6 * abs(a0)
    assert torch.allclose(g0, g1, atol=1e-4 * float(g0.abs().max()), rtol=0)


@pytest.mark.gpu
def test_moe_serving_on_card_launches_flash_once_per_layer(cuda_device):
    """The reduced Qwen3-MoE in bf16 at head dim 128 with GQA 16:1 (the full
    model's): one tensor-core flash launch per layer per prefill, none per
    decode step, finite logits."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_config("qwen3_moe_235b_a22b", reduced=True), attn_impl="flash",
                              param_dtype="bfloat16", head_dim=128, num_heads=16, num_kv_heads=1)
    bundle = build_model(cfg, cuda_device)
    params = bundle.init(torch.Generator(device=cuda_device).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device)
    fkernel.reset_launches()
    out = generate(bundle, params, prompts, 4)
    assert fkernel.ROUTES["flash_forward_sm90"].launches == cfg.num_layers
    assert fkernel.flash_attention_bhsd.launches == cfg.num_layers
    assert out.all_finite and out.tokens.shape == (2, 4)


@pytest.mark.gpu
def test_decode_pool_on_card_is_byte_invisible(cuda_device):
    """The int8_blocks loopback job on the card with the decode pool at 0
    and at 4 (its threads dequantize on the card): the same bytes and the
    same launch counts."""
    import dataclasses

    from repro_torch.core import channels

    rng = np.random.default_rng(2)
    w0 = {"w": rng.normal(size=(96, 129)).astype(np.float32),
          "b": rng.normal(size=(129,)).astype(np.float32)}
    tag = classical_fl()
    tag = dataclasses.replace(tag, channels=tuple(
        dataclasses.replace(c, backend="multiproc", codec="int8_blocks") for c in tag.channels))
    out = []
    prev = channels.decode_pool_workers()
    try:
        for workers in (0, 4):
            channels.set_decode_pool(workers)
            job = JobSpec(tag=tag, datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(6)),
                          hyperparams={"rounds": 2, "init_weights": w0})
            qkernel.reset_launches()
            res = run_job(job, device=cuda_device, timeout=120,
                          program_overrides={"trainer": AddOneTrainer})
            assert not res.errors, res.errors
            out.append((tree_to_numpy(res.global_weights()), qkernel.dequantize_blocks.launches))
    finally:
        channels.set_decode_pool(prev)
    (a, na), (b, nb) = out
    assert all(a[k].tobytes() == b[k].tobytes() for k in a) and na == nb > 0


# ---------------------------------------------------------------------- #
# strategies, policies and checkpoints on the card
# ---------------------------------------------------------------------- #
def _delta_tree(gen, dev, scale=1.0):
    return {"w": scale * torch.randn(33, 70, generator=gen, device=dev),
            "b": scale * torch.randn(4099, generator=gen, device=dev),
            "blocks": [scale * torch.randn(5, 2, 2, generator=gen, device=dev)]}


def _tree_bits(tree):
    from repro_torch.core.tree import tree_leaves

    return [x.contiguous().cpu().numpy().tobytes() for x in tree_leaves(tree)]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fedbuff", "fedasync"])
def test_async_absorb_and_batch_on_card_match_plain_versions(cuda_device, name):
    """``accumulate_stream`` (one tree fold launch per update, on the zeros
    accumulator) and ``accumulate_batch`` (one stacked fold launch per leaf)
    on the card give the plain chain's bits: host weight, ``0 + w*d`` folds,
    ``p + lr * acc / count``."""
    from repro_torch.core.tree import tree_map
    from repro_torch.fl.strategies import get_strategy

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    kw = {"buffer_size": 4, "server_lr": 0.7} if name == "fedbuff" else {}
    s = get_strategy(name, **kw)
    params = _delta_tree(gen, cuda_device)
    deltas = [_delta_tree(gen, cuda_device, 0.1) for _ in range(4)]
    deltas[0]["w"][0] = -0.0
    stals = [0, 3, 1, 2]
    kernel.reset_launches()
    stream = s.init(params)
    for d, st in zip(deltas, stals):
        stream = s.accumulate_stream(stream, d, st)
    assert kernel.exact_fold_into_tree.launches == 4
    batch = s.accumulate_batch(s.init(params), deltas, stals)
    assert kernel.exact_fold.launches == 3  # one per leaf
    plain = tree_map(torch.zeros_like, params)
    for d, st in zip(deltas, stals):
        w = float(s._update_weight(st))
        plain = tree_map(lambda a, x: ref.exact_fold_into(a, x, w), plain, d)
    want = _tree_bits(plain)
    assert _tree_bits(stream["acc"]) == want and _tree_bits(batch["acc"]) == want
    new, _ = s.apply(params, None, stream)
    host = s.apply(tree_map(lambda x: x.cpu(), params), None,
                   {"acc": tree_map(lambda x: x.cpu(), plain), "count": stream["count"]})[0]
    assert _tree_bits(new) == _tree_bits(host)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fedbuff", "fedasync"])
def test_batch_on_part_filled_state_launches_tree_folds(cuda_device, name):
    """``accumulate_batch`` on a state that already holds an update folds
    the rest one ``exact_fold_into_tree`` launch each (no stacked fold) and
    gives the plain chain's bits."""
    from repro_torch.core.tree import tree_map
    from repro_torch.fl.strategies import get_strategy

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    s = get_strategy(name, **({"buffer_size": 4} if name == "fedbuff" else {}))
    params = _delta_tree(gen, cuda_device)
    deltas = [_delta_tree(gen, cuda_device, 0.1) for _ in range(4)]
    stals = [2, 0, 1, 3]
    plain = tree_map(torch.zeros_like, params)
    for d, st in zip(deltas, stals):
        w = float(s._update_weight(st))
        plain = tree_map(lambda a, x: ref.exact_fold_into(a, x, w), plain, d)
    state = s.accumulate_stream(s.init(params), deltas[0], stals[0])
    kernel.reset_launches()
    state = s.accumulate_batch(state, deltas[1:], stals[1:])
    assert kernel.exact_fold_into_tree.launches == 3
    assert kernel.exact_fold.launches == 0
    assert int(state["count"]) == 4
    assert _tree_bits(state["acc"]) == _tree_bits(plain)


@pytest.mark.gpu
def test_policy_jobs_on_card_equal_cpu(cuda_device, tmp_path):
    """A deadline job with a straggler, and a one-trainer async job restarted
    from its checkpoint: the card's weights, logs and restored step are the
    CPU's."""
    w0 = {"w": np.full((64, 33), 0.5, np.float32), "b": np.zeros((33,), np.float32)}

    class ScaleAdd(Trainer):
        def train(self):
            if self.weights is not None:
                self.weights = {k: v * 0.75 + 1.0 for k, v in self.weights.items()}

    from repro_torch.core.runtime import RuntimePolicy

    out = {}
    for name, device in (("card", cuda_device), ("host", "cpu")):
        job = JobSpec(tag=classical_fl(), datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(4)),
                      hyperparams={"rounds": 3, "init_weights": w0})
        res = run_job(job, device=device, timeout=120, program_overrides={"trainer": ScaleAdd},
                      policy=RuntimePolicy(mode="deadline", deadline=2.0, grace=10.0),
                      per_worker_hyperparams={"trainer-1": {"compute_time": 5.0}})
        assert not res.errors, res.errors
        runs = [tree_to_numpy(res.global_weights()),
                res.program("global-aggregator-0").participation_log]
        for rounds in (2, 4):
            job = JobSpec(tag=classical_fl(), datasets=(DatasetSpec(name="d0"),),
                          hyperparams={"rounds": rounds, "init_weights": w0,
                                       "checkpoint_every": 1, "checkpoint_dir": str(tmp_path / name)})
            res = run_job(job, device=device, timeout=120, program_overrides={"trainer": ScaleAdd},
                          policy=RuntimePolicy(mode="async", buffer_size=1, grace=10.0))
            assert not res.errors, res.errors
            glob = res.program("global-aggregator-0")
            runs += [tree_to_numpy(res.global_weights()),
                     [m for m in glob.metrics if "restored_step" in m], glob.staleness_log]
        out[name] = runs
    card, cpu = out["card"], out["host"]
    for a, b in zip(card, cpu):
        if isinstance(a, dict):
            assert {k: v.tobytes() for k, v in a.items()} == {k: v.tobytes() for k, v in b.items()}
        else:
            assert a == b
    assert card[6] == [{"restored_step": 2}]


@pytest.mark.gpu
def test_checkpoint_restores_onto_the_card(cuda_device, tmp_path):
    from repro_torch import checkpoint

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    tree = _delta_tree(gen, cuda_device)
    checkpoint.save(str(tmp_path), 7, tree)
    like = {"w": torch.zeros(33, 70), "b": torch.zeros(4099), "blocks": [torch.zeros(5, 2, 2)]}
    got = checkpoint.restore(str(tmp_path), 7, like, strict=True, device=cuda_device)
    assert all(x.device == cuda_device for x in [got["w"], got["b"], got["blocks"][0]])
    assert _tree_bits(got) == _tree_bits(tree)
    loaded = checkpoint.load_tree(str(tmp_path), 7, device=cuda_device)
    assert loaded["blocks"]["#0"].device == cuda_device
    assert _tree_bits(loaded["blocks"]["#0"]) == _tree_bits(tree["blocks"][0])


def _coded_job(trainers, plan):
    import dataclasses

    rng = np.random.default_rng(5)
    w0 = {"w": rng.normal(size=(96, 129)).astype(np.float32),
          "b": rng.normal(size=(129,)).astype(np.float32)}
    tag = classical_fl(trainer_program="_torch_programs.HalfTrainer")
    tag = dataclasses.replace(tag, channels=tuple(
        dataclasses.replace(c, backend="multiproc", codec="int8_blocks") for c in tag.channels))
    return JobSpec(tag=tag, datasets=tuple(DatasetSpec(name=f"d{i}") for i in range(trainers)),
                   hyperparams={"rounds": 2, "init_weights": w0, "reduce_plan": plan})


@pytest.mark.gpu
def test_reduced_process_job_folds_in_the_hub_on_card(cuda_device):
    """A two-process job (one trainer, the root) with ``reduce_plan`` 1 on an
    ``int8_blocks`` channel: the hub, in this process, decodes each upload
    with the dequantize kernel and folds it with the tree fold kernel, one
    launch of each per update (2 rounds x 1 trainer), and the weights equal
    the threaded loopback run's on the card."""
    from repro_torch.launch.spawn import run_job_multiproc

    kernel.reset_launches()
    qkernel.reset_launches()
    res = run_job_multiproc(_coded_job(1, 1), device=cuda_device, timeout=300)
    hub = (kernel.exact_fold_into_tree.launches, qkernel.dequantize_blocks.launches,
           kernel.exact_fold_into.launches, qkernel.quantize_blocks.launches)
    assert not res.errors, res.errors
    assert hub == (2, 2, 0, 0)
    root = res.program("global-aggregator-0")
    assert root.peak_device_bytes > 0
    # the root folds the one partial (a tree launch a round) and quantizes
    # its 3 broadcasts; the trainer dequantizes them and quantizes 2 uploads
    assert root.launches["exact_fold_into_tree"] == 2 and root.launches["quantize_blocks"] == 3
    trainer = res.program("trainer-0")
    assert trainer.launches["dequantize_blocks"] == 3 and trainer.launches["quantize_blocks"] == 2
    assert res.channel_stats["param-channel"]["hub_partials"] == 2.0
    threads = run_job(_coded_job(1, 1), device=cuda_device, timeout=120)
    assert not threads.errors, threads.errors
    a, b = tree_to_numpy(res.global_weights()), tree_to_numpy(threads.global_weights())
    assert res.global_weights()["w"].device.type == "cuda"
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_child_given_the_card_where_there_is_none_fails(cuda_device, monkeypatch):
    """Children that find no card (``CUDA_VISIBLE_DEVICES`` empty in their
    environment) raise, and the errors land in ``JobResult.errors``: no
    child falls back to the CPU."""
    from repro_torch.launch.spawn import run_job_multiproc

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    res = run_job_multiproc(_coded_job(1, 0), device=cuda_device, timeout=120)
    assert set(res.errors) >= {"trainer-0", "global-aggregator-0"}
    assert all("no CUDA device" in str(res.errors[w]) for w in ("trainer-0", "global-aggregator-0"))


# ---------------------------------------------------------------------- #
# the federated train step on the card
# ---------------------------------------------------------------------- #
@pytest.mark.gpu
def test_fed_step_on_card_equals_cpu(cuda_device):
    """The reduced Qwen2.5-3B (float32) over 2 virtual clients, FedAdam, 2
    rounds, on the card and on the CPU from the same parameters and batches:
    loss rtol 1e-5, ``delta_norm`` rtol 1e-4, parameters within 1e-4
    (``tests/test_torch_train.py``'s tolerances against the JAX package:
    float32 products in other orders), and no kernel of ours launched (the
    stages are float32 sums)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.datasets import synthetic_lm_batches
    from repro_torch.fl.fedstep import FedStepConfig
    from repro_torch.launch.mesh import make_virtual_mesh
    from repro_torch.launch.steps import build_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2_5_3b", reduced=True)
    fed = FedStepConfig(local_steps=2, local_lr=0.05)
    it = synthetic_lm_batches(cfg.vocab_size, 8, 16, seed=0)
    batches = [next(it) for _ in range(2)]
    params0 = None
    out = {}
    kernel.reset_launches()
    for dev in (cuda_device, torch.device("cpu")):
        bundle, setup = build_train_step(cfg, make_virtual_mesh(2), fed, device=dev)
        if params0 is None:
            params0 = tree_map(lambda x: x.cpu(), bundle.init(
                torch.Generator(device=dev).manual_seed(0)))
        params = tree_map(lambda x: x.to(dev), params0)
        state = setup.init_state(params)
        hist = []
        for i, tokens in enumerate(batches):
            params, state, m = setup.step(params, state, {"tokens": tokens}, i)
            hist.append(({k: float(v) for k, v in m.items()},
                         [x.cpu() for x in tree_leaves(params)]))
        out[dev.type] = hist
    assert all(fn.launches == 0 for fn in kernel.KERNELS)
    for (gm, gp), (cm, cp) in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(gm["loss"], cm["loss"], rtol=1e-5)
        np.testing.assert_allclose(gm["delta_norm"], cm["delta_norm"], rtol=1e-4)
        for a, b in zip(gp, cp):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_float32_logits_of_bf16_have_a_gradient(cuda_device):
    """The bf16 unembedding's float32 logits on the card (one cuBLAS product,
    a hand-written backward): forward and both gradients against the
    float32 product of the same bf16 values, within bf16 rounding; each
    bf16 gradient within one bf16 ulp (2**-7 relative) of the float32
    gradient, plus 2**-16 of the largest where a sum cancels (float32 sums
    in other orders), and at most 1% of elements off its rounding, as a
    float32 cotangent gives (0.04% on an H100; one rounded to bf16 first put
    35% and 40% off)."""
    from repro_torch.models.layers import unembed_apply

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((2, 9, 256), generator=gen, device=cuda_device).to(torch.bfloat16)
    emb = (0.05 * torch.randn((1000, 256), generator=gen, device=cuda_device)).to(torch.bfloat16)
    t = torch.randint(0, 1000, (2, 9), generator=gen, device=cuda_device)
    outs = []
    for f32 in (False, True):
        xs = (x.float() if f32 else x).detach().requires_grad_(True)
        es = (emb.float() if f32 else emb).detach().requires_grad_(True)
        logits = unembed_apply({"emb": es}, xs)
        assert logits.dtype == torch.float32
        torch.nn.functional.cross_entropy(logits.reshape(-1, 1000), t.reshape(-1)).backward()
        outs.append((logits.detach(), xs.grad.float(), es.grad.float()))
    for a, b in zip(outs[0], outs[1]):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2e-2 * scale, (float((a - b).abs().max()), scale)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert bool(((a - b).abs() <= 2.0**-7 * b.abs() + 2.0**-16 * b.abs().max()).all())
        off = float((a != b.bfloat16().float()).float().mean())
        assert off <= 0.01, off


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba_1_5b", "xlstm_1_3b", "seamless_m4t_medium", "gemma_7b"])
def test_family_prefill_and_step_on_card_equal_cpu(cuda_device, arch):
    """Each family's reduced config (float32) on the card against the CPU
    from the same weights: the prefill's and a decode step's logits within
    2e-4 (float32 products in other orders), the flash route on the card
    (flash.cu at float32 D 32) against the plain attention on the CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models.api import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, reduced=True), attn_impl="flash")
    card, cpu = build_model(cfg, cuda_device), build_model(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :32]}
    if cfg.encoder_layers:
        batch["frames"] = 0.1 * torch.randn(2, cfg.frontend_len, cfg.d_model,
                                            generator=torch.Generator().manual_seed(2))
    out = {}
    for name, bundle, dev in (("cpu", cpu, "cpu"), ("card", card, cuda_device)):
        p = tree_map(lambda x: x.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        fkernel.reset_launches()
        logits, cache = bundle.prefill(p, b, bundle.init_cache(2, 40))
        step, _ = bundle.serve_step(p, cache, {"token": toks[:, 32:].to(dev)})
        out[name] = (logits.cpu(), step.cpu(), fkernel.flash_attention_bhsd.launches)
    for a, b in zip(out["card"][:2], out["cpu"][:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=0)
    attention_layers = 0 if arch == "xlstm_1_3b" else cfg.num_layers
    assert out["card"][2] == attention_layers and out["cpu"][2] == 0


@pytest.mark.gpu
def test_ssd_recurrences_on_card_equal_cpu(cuda_device):
    """ssd_chunked, ssd_decode_step and slstm_scan on the card against the
    CPU, float32, within 1e-5 (the CPU twins' bound against the JAX
    package)."""
    from repro_torch.models import ssd

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 64, 3, 8, generator=g), 0.3 * torch.randn(2, 64, 3, 8, generator=g)
    v = torch.randn(2, 64, 3, 16, generator=g)
    ld = -torch.nn.functional.softplus(torch.randn(2, 64, 3, generator=g))
    gate = torch.sigmoid(torch.randn(2, 64, 3, generator=g))
    s0 = torch.randn(2, 3, 8, 16, generator=g)
    gates = [3 * torch.randn(2, 24, 16, generator=g) for _ in range(4)]
    runs = {}
    for dev in ("cpu", cuda_device):
        to = [x.to(dev) for x in (q, k, v, ld, gate, s0)]
        y, final = ssd.ssd_chunked(*to[:5], chunk=16, initial_state=to[5])
        y1, s1 = ssd.ssd_decode_step(to[5], to[0][:, 0], to[1][:, 0], to[2][:, 0], to[3][:, 0],
                                     to[4][:, 0])
        h, carry = ssd.slstm_scan(*[x.to(dev) for x in gates])
        runs[str(dev)] = [t.cpu() for t in (y, final, y1, s1, h, *carry)]
    for a, b in zip(runs[str(cuda_device)], runs["cpu"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
