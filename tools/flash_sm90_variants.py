"""Build and time variants of the tensor-core flash kernel on one CUDA card.

Each variant is ``csrc/flash_sm90.cu`` with a few lines replaced (the KV
tile width, the ring's depth, a producer warpgroup with ``setmaxnreg``,
turns between the consumer warpgroups, the exp2 instruction). All are compiled at once with the port's nvcc flags into
``build/flash_sm90_variants/``; for each the script prints ptxas's registers,
spills and wgmma warnings, then, in a child process with a time limit, its
relative L2 error against the plain version on four small shapes and its
time at the serving shape (B 8, S 2048, H 16/2, D 128, bf16, causal and
not), beside ``scaled_dot_product_attention``'s in the same process; and,
from ``cuobjdump -sass``, the highest register each kernel names. Run
from the root of a checkout:

    python3 tools/flash_sm90_variants.py
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402

SOURCE = fkernel.CSRC / "flash_sm90.cu"
OUT = ROOT / "build" / "flash_sm90_variants"
VARIANTS = {
    "as_built": [],
    "bk64": [("constexpr int kBK = 128;", "constexpr int kBK = 64;")],
    "three_stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "producer_warpgroup_setmaxnreg": [
        ("constexpr int kThreads = 288;", "constexpr int kThreads = 384;"),
        ("    if (threadIdx.x == 256) {",
         '    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");\n'
         "    if (threadIdx.x == 256) {"),
        ("    const int cw = wg;",
         '    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");\n'
         "    const int cw = wg;"),
    ],
    # FA3's ping-pong: the consumer warpgroups take turns to issue S = Q K^T
    # (named barriers 1 and 2), so one's softmax overlaps the other's product
    "pingpong": [
        ("    mbar_wait(q_full, 0);\n",
         "    mbar_wait(q_full, 0);\n"
         '    if (cw == 1 && n_kv > 0) asm volatile("bar.arrive 1, 256;" ::: "memory");\n'),
        ("      mbar_wait(k_full(s), phase);\n      wgmma_fence();",
         "      mbar_wait(k_full(s), phase);\n"
         '      asm volatile("bar.sync %0, 256;" ::"r"(1 + cw) : "memory");\n'
         "      wgmma_fence();"),
        ("      wgmma_commit();\n      wgmma_wait_all();\n      fence_regs(sc);",
         "      wgmma_commit();\n"
         "      if (cw == 0 || it + 1 < n_kv)\n"
         '        asm volatile("bar.arrive %0, 256;" ::"r"(2 - cw) : "memory");\n'
         "      wgmma_wait_all();\n      fence_regs(sc);"),
    ],
    "ex2_ftz": [
        ("__device__ __forceinline__ uint32_t pack_bf16(",
         "__device__ __forceinline__ float ex2_ftz(float x) {\n  float y;\n"
         '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));\n  return y;\n}\n\n'
         "__device__ __forceinline__ uint32_t pack_bf16("),
        ("alpha[r] = exp2f(", "alpha[r] = ex2_ftz("),
        ("sc[i] = exp2f(", "sc[i] = ex2_ftz("),
    ],
}
VARIANTS["pingpong_three_stages"] = VARIANTS["pingpong"] + VARIANTS["three_stages"]
PARITY_SHAPES = [(2, 300, 4, 2, 128, True, 0), (1, 400, 4, 1, 128, True, 100),
                 (1, 256, 4, 4, 64, False, 0), (1, 97, 2, 1, 64, False, 40)]


def compile_variant(name: str):
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            return name, 1, [f"the source no longer holds {old!r}"]
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(text)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    lines = [ln.strip()[-300:] for ln in (proc.stdout + proc.stderr).splitlines()
             if any(w in ln for w in ("C75", "spill", "Used", "error"))]
    if proc.returncode == 0:
        lines.append(sass_registers(so))
    return name, proc.returncode, lines


def sass_registers(so: Path) -> str:
    """The highest register each kernel's SASS names, and whether it holds
    setmaxnreg (``USETMAXREG``), from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                              timeout=120).stdout
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"sass: {exc}"
    out = []
    for part in sass.split("Function : ")[1:]:
        head = part.split(maxsplit=1)[0]
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", part)]
        out.append(f"D {re.search(r'ILi(\d+)E', head).group(1) if 'ILi' in head else '?'}: "
                   f"highest R{max(regs, default=0)}, USETMAXREG {'USETMAXREG' in part}")
    return "sass: " + "; ".join(out)


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(name: str) -> dict:
    lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    fkernel._bind_sm90(lib)
    fkernel.SM90_LIBRARY._lib = lib  # the wrapper launches this variant
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(B, S, H, Hkv, D):  # the model's (B, S, H, D) tensors as (B, H, S, D) views
        return [torch.randn(B, S, h, D, generator=gen, device=dev).bfloat16().transpose(1, 2)
                for h in (H, Hkv, Hkv)]

    rel = []
    for B, S, H, Hkv, D, causal, window in PARITY_SHAPES:
        q, k, v = qkv(B, S, H, Hkv, D)
        out = fkernel.flash_forward_sm90(q, k, v, causal=causal, window=window)
        plain = ref.reference_attention(*(x.transpose(1, 2) for x in (q, k, v)),
                                        causal=causal, window=window).transpose(1, 2)
        rel.append(float((out.double() - plain.double()).norm() / plain.double().norm()))
    q, k, v = qkv(8, 2048, 16, 2, 128)
    return {
        "variant": name, "rel_l2": rel,
        "ms": cuda_ms(lambda: fkernel.flash_forward_sm90(q, k, v)),
        "ms_noncausal": cuda_ms(lambda: fkernel.flash_forward_sm90(q, k, v, causal=False)),
        "sdpa_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
    }


def main() -> int:
    if sys.argv[1:2] == ["--measure"]:
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("flash_sm90_variants: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(compile_variant, VARIANTS))
    print(f"build_s {time.perf_counter() - t0:.1f}")
    for name, rc, lines in built:
        print(f"{name}: nvcc rc {rc}")
        for ln in lines:
            print(f"    {ln}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    failed = 0
    for name, rc, _ in built:
        if rc:
            failed += 1
            continue
        try:
            proc = subprocess.run([sys.executable, __file__, "--measure", name], timeout=180,
                                  capture_output=True, text=True)
            print(proc.stdout.strip() or f"{name}: failed\n{proc.stderr[-2000:]}", flush=True)
            failed += proc.returncode != 0
        except subprocess.TimeoutExpired:
            print(f"{name}: timed out", flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
