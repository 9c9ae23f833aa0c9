#!/usr/bin/env python3
"""Where the fused-prediction kernel's time goes, by taking parts of it away.

Run from the root of a checkout on a machine with one NVIDIA GPU and ``nvcc``:
``python3 tools/kernel_ablation.py``. It needs no network and writes
under ``build/ablation/``.

The script derives variants of ``trieste_tpu_torch/csrc/fused_predict.cu`` by text
substitution, builds them side by side (one ``nvcc`` each, all started together), and times
each at the production shape (N = 131072, C = 1024, D = 6, matern52, P = 1) with CUDA
events: the main kernel alone, on operands packed once, median of 20 launches, two rounds
in turns. Variants:

- ``whole``: the kernel as it is;
- ``no_wgmma``: the tensor-core products removed (K evaluation, stream and epilogue stay);
- ``no_k_eval``: r², k(r) and the distance loop removed (the products and the stream stay);
- ``stream_only``: both removed: the chunk stream through the ring and the barriers;
- ``stream+spin`` and ``no_k_eval+spin``: three otherwise idle warps of the producer
  warpgroup run a register-only FMA loop, without and with the tensor-core products beside
  them: how far fp32 work in other warps overlaps with ``wgmma``;
- ``single_chain``: the tensor cores accumulate over the whole k range of a panel instead
  of one k tile at a time (no rounded additions in registers);
- ``n256_single_chain``: the same with 256-column panels (128 accumulators a thread),
  the widest ``wgmma``.

The last two and ``whole`` compute the function, so their error against the fp64 plain
version is printed too, on the white-noise case of ``chip_smoke.py`` (rbf, C = 1024,
N = 3001) beside the plain fp32 version's. The other variants compute nothing meaningful.
The last line is one JSON object with every number.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ablation"

WGMMA3 = """          wgmma_m64n128k8_tf32(acc, lo, desc_hi, s != 0);   // small terms first
          wgmma_m64n128k8_tf32(acc, hi, desc_lo, 1);
          wgmma_m64n128k8_tf32(acc, hi, desc_hi, 1);
"""
DISTANCES = "  rows.r2(t1, t2, r);\n"
STATIONARY = "kv[e] = kvar * stationary<KIND>(r[e]);"
PRODUCER = "    if (tid == CONSUMER_THREADS) {"
SPIN = """    if (tid >= CONSUMER_THREADS + 32) {
      float x0 = tid, x1 = tid + 1, x2 = tid + 2, x3 = tid + 3;
      for (int i = 0; i < 60000; ++i) {
        x0 = fmaf(x0, 1.0001f, 0.5f); x1 = fmaf(x1, 1.0001f, 0.5f);
        x2 = fmaf(x2, 1.0001f, 0.5f); x3 = fmaf(x3, 1.0001f, 0.5f);
      }
      if (x0 + x1 + x2 + x3 == 12345.678f) var[0] = x0;
    }
"""


def replace(text: str, *pairs: tuple[str, str]) -> str:
    for old, new in pairs:
        if old not in text:
            raise SystemExit(f"kernel_ablation: the kernel source no longer has {old!r}")
        text = text.replace(old, new)
    return text


def wgmma_wrapper(n: int) -> str:
    """The source's wgmma wrapper (same name, so its call sites stay) for width ``n``."""
    acc = n // 2
    regs = ", ".join(f"%{i}" for i in range(acc))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(acc))
    return f"""__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[ACC], const uint32_t (&a)[4],
                                                     uint64_t desc, int accumulate) {{
  asm volatile(
      "{{\\n"
      ".reg .pred p;\\n"
      "setp.ne.b32 p, %{acc + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
      "{{{regs}}},"
      " {{%{acc}, %{acc + 1}, %{acc + 2}, %{acc + 3}}}, %{acc + 4}, p, 1, 1;\\n"
      "}}\\n"
      : {outs}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
      : "memory");
}}

"""


def variants(src: str) -> dict[str, str]:
    no_k_eval = replace(src, (DISTANCES, ""), (STATIONARY, "kv[e] = kvar + r[e];"))
    stream_only = replace(no_k_eval, (WGMMA3, ""))
    single_chain = replace(
        src, ("desc_hi, s != 0);", "desc_hi, (kt | s) != 0);"), ("v[i] += acc[i];", ""),
        ("quad_b = fmaf(v[i], v[i], quad_b);", "quad_b = fmaf(acc[i], acc[i], quad_b);"),
        ("quad_a = fmaf(v[i], v[i], quad_a);", "quad_a = fmaf(acc[i], acc[i], quad_a);"),
    )
    start, stop = single_chain.index("#define ACC4(i)"), single_chain.index("// ---- pack:")
    n256 = replace(single_chain[:start] + wgmma_wrapper(256) + single_chain[stop:],
                   ("constexpr int BN = 128;", "constexpr int BN = 256;"),
                   ("constexpr int STAGES = 4; ", "constexpr int STAGES = 3; "),   # of 64 KB
                   ("static_assert(ACC == 64,", "static_assert(ACC == 128,"))
    return {
        "whole": src,
        "no_wgmma": replace(src, (WGMMA3, "")),
        "no_k_eval": no_k_eval,
        "stream_only": stream_only,
        "stream+spin": replace(stream_only, (PRODUCER, SPIN + PRODUCER)),
        "no_k_eval+spin": replace(no_k_eval, (PRODUCER, SPIN + PRODUCER)),
        "single_chain": single_chain,
        "n256_single_chain": n256,
    }


def runner(fp, lib, kind, xs, A, alpha, LinvT, scal):
    """Pack once with ``lib``; return the function that launches its main kernel alone."""
    packed = fp.pack(A, alpha, LinvT, lib=lib)
    return lambda: fp.launch_packed(kind, xs, A, packed, scal, alpha.shape[1], lib=lib)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import compare, median_ms, synthetic_state
    from trieste_tpu_torch.ops import fused_predict as fp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    OUT.mkdir(parents=True, exist_ok=True)
    builds = {}
    for name, text in variants(fp._SOURCE.read_text()).items():
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        builds[name] = (so, subprocess.Popen(
            [fp._nvcc(), *fp._NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in builds.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"kernel_ablation: nvcc failed for {name}\n{out[-3000:]}")
        libs[name] = fp.bind(so)

    # production shape: timing only, the values do not matter
    g = torch.Generator(device=dev).manual_seed(1)
    N, C, D = 131072, 1024, 6
    xs = torch.rand(N, D, generator=g, device=dev)
    A = torch.rand(C, D, generator=g, device=dev)
    alpha = torch.randn(C, 1, generator=g, device=dev)
    LinvT = (torch.randn(C, C, generator=g, device=dev) / 32).triu().contiguous()
    scal = torch.tensor([1.0, 0.0], device=dev)
    result = {"card": smi, "ms": {}, "white_noise": {}}
    times = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            times[name].append(median_ms(runner(fp, lib, "matern52", xs, A, alpha, LinvT, scal), reps=20))
    for name, ts in times.items():
        result["ms"][name] = statistics.mean(ts)
        print(f"{name:>18}: {ts[0]:.4f} ms, {ts[1]:.4f} ms")

    # white-noise case of chip_smoke.py phase 2: the variants that compute the function
    params, cache, g = synthetic_state("rbf", 1024, 1, seed=7, device=dev, white_noise=True)
    flat = torch.rand(3001, 6, generator=g, dtype=torch.float64, device=dev)
    ops = fp.operands(params, cache, flat)
    args = tuple(t.float().contiguous() for t in ops[1:])
    plain = fp.fused_predict_reference("rbf", *(t.double() for t in args))
    em32, ev32, *_ = compare(fp.fused_predict_reference("rbf", *args), plain)
    result["white_noise"]["plain_fp32"] = {"mean_abs_err": em32, "var_abs_err": ev32}
    print(f"white-noise rbf C=1024 N=3001: plain fp32 mean abs {em32:.3e} var abs {ev32:.3e}")
    for name in ("whole", "single_chain", "n256_single_chain"):
        out = runner(fp, libs[name], "rbf", *args)()
        torch.cuda.synchronize()
        em, ev, *_ = compare(out, plain)
        result["white_noise"][name] = {"mean_abs_err": em, "var_abs_err": ev}
        print(f"{name:>18}: mean abs {em:.3e} var abs {ev:.3e}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
