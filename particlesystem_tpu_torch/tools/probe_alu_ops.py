"""Measure the per-lane cost of FP32 op classes on the card.

Counterpart of ``tools/probe_vpu_ops.py``: ``k`` dependent layers of one op
class on a (512, 1024) float32 tile, timed at ``k = 64`` and ``k = 192``;
the k-slope cancels launch, load and store, and gives ns per layer, lanes
per second, the ratio to ``fma`` and the share of the card's FP32 peak.
A hand count of a kernel's float operations (the cluster-pair kernel's
bound in ``PERF.md``) can then be turned into time with measured costs
instead of assumed ones.

Op classes (``t = acc + float(j) * 1e-30`` feeds the loop index into the
data in every layer; ``c = 1.0000001``):

  fma         acc = t * c + x
  mul         acc = t * x
  cmp         acc = t + float(x > t)
  select      acc = where(x > t, x, t)
  and2        acc = where((x > t) & (x < c), x, t)
  rsqrt       acc = rsqrt(t + x)
  chain16     16 fused multiply-adds a = a * c + x in one layer
  chainmix16  4 x (two compares, an and, a multiply-add, a select)

Every layer also carries the add of ``t`` (one FADD a lane) and, once a
thread, the two operations that make ``float(j) * 1e-30``; so ``fma`` and
``mul`` issue two FP32 operations a lane and layer, and ``chain16`` (17
for 16) is the variant that shows the register-resident rate.

:func:`probe_layers` launches the CUDA kernel (``csrc/probe_alu_ops.cu``)
for a CUDA tensor and takes :func:`probe_layers_plain` for a CPU tensor.
The plain version rounds as the kernel does: ``t * c + x`` once (the
product is exact in float64 and, for inputs of comparable magnitude, so is
the sum, which is then rounded to float32 once), everything else as
written.  ``rsqrt`` differs by the 2 ulp of the card's approximation.

Usage: python -m particlesystem_tpu_torch.tools.probe_alu_ops
       python -m particlesystem_tpu_torch.tools.probe_alu_ops --sass
"""

from __future__ import annotations

import functools
import re
import sys

import numpy as np
import torch

from ..utils.cuda_build import by_device, launch

B, CH = 512, 1024
REPS = 64           # repeats of the tile per launch (the TPU grid's 64 steps)
K1, K2 = 64, 192
VARIANTS = ("fma", "mul", "cmp", "select", "and2", "rsqrt", "chain16",
            "chainmix16")
C = np.float32(1.0000001).item()
# operations a lane and layer, as tools/probe_vpu_ops.py counts them (the
# add of t not included)
OPS = dict(fma=1, mul=1, cmp=2, select=2, and2=4, rsqrt=1, chain16=16,
           chainmix16=20)
# FMA lanes per second at the card's published FP32 peak (67 TFLOP/s)
FP32_FMA_LANES_PER_S = 33.5e12


def _fma(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a * C + x`` rounded once, as FFMA rounds it."""
    return (a.double() * C + x.double()).float()


def probe_layers_plain(variant: str, k: int, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``k`` layers of ``variant`` on
    every element of the float32 tensor ``x``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    acc = x * 0.5
    for j in range(k):
        t = acc + (np.float32(j) * np.float32(1e-30)).item()
        if variant == "fma":
            acc = _fma(t, x)
        elif variant == "mul":
            acc = t * x
        elif variant == "cmp":
            acc = t + (x > t).float()
        elif variant == "select":
            acc = torch.where(x > t, x, t)
        elif variant == "and2":
            acc = torch.where((x > t) & (x < C), x, t)
        elif variant == "rsqrt":
            acc = torch.rsqrt(t + x)
        elif variant == "chain16":
            acc = t
            for _ in range(16):
                acc = _fma(acc, x)
        else:
            acc = t
            for _ in range(4):
                m = (acc > x) & (acc < C)
                acc = torch.where(m, _fma(acc, x), acc)
    return acc


def probe_layers_cuda(variant: str, k: int, x: torch.Tensor,
                      reps: int = REPS) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: ``reps`` repeats of the
    tile ``x`` spread over the grid; returns repeat 0's result."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 tensor")
    if x.numel() == 0 or x.numel() % 8 or x.data_ptr() % 16:
        raise ValueError(f"x must hold a positive multiple of 8 lanes, "
                         f"16-byte aligned; got {x.numel()}")
    if reps < 1 or k < 0:
        raise ValueError(f"reps={reps} and k={k} must be >= 1 and >= 0")
    out = torch.empty_like(x)
    launch("ps_probe_alu_ops", x.device, x.data_ptr(), out.data_ptr(),
           x.numel(), reps, VARIANTS.index(variant), k)
    return out


def probe_layers(variant: str, k: int, x: torch.Tensor,
                 reps: int = REPS) -> torch.Tensor:
    """``k`` layers of ``variant`` on ``x``: the kernel for a CUDA tensor,
    the plain version for a CPU one."""
    return by_device(x, "probe kernel",
                     functools.partial(probe_layers_cuda, reps=reps),
                     probe_layers_plain)(variant, k, x)


def tile(device) -> torch.Tensor:
    """The probe's input: a seeded uniform [0, 1) float32 (512, 1024) tile."""
    x = np.random.default_rng(0).random((B, CH), np.float32)
    return torch.tensor(x, device=device)


def _ms(fn, launches: int = 10, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean milliseconds of ``launches``
    back-to-back calls, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def measure(device="cuda", reps: int = REPS) -> dict:
    """Time every variant at ``K1`` and ``K2`` in this process; returns
    {variant: {ms_k1, ms_k2, ns_per_layer, lanes_per_s, x_fma,
    share_of_peak}}.  ``ns_per_layer`` is for one pass over the tile (the
    launch's slope over its ``reps`` repeats); ``share_of_peak`` is the
    variant's :data:`OPS` times its lanes per second over the FMA lanes per
    second of the card's FP32 peak."""
    x = tile(device)
    out = {}
    for v in VARIANTS:
        t1 = _ms(lambda: probe_layers_cuda(v, K1, x, reps))
        t2 = _ms(lambda: probe_layers_cuda(v, K2, x, reps))
        per_layer_s = (t2 - t1) * 1e-3 / ((K2 - K1) * reps)
        out[v] = dict(ms_k1=t1, ms_k2=t2, ns_per_layer=per_layer_s * 1e9,
                      lanes_per_s=B * CH / per_layer_s)
    base = out["fma"]["ns_per_layer"]
    for r in out.values():
        r["x_fma"] = r["ns_per_layer"] / base
    for v, r in out.items():
        r["share_of_peak"] = (OPS[v] * r["lanes_per_s"]
                              / FP32_FMA_LANES_PER_S)
    return out


def sass_counts() -> dict:
    """{kernel variant: {mnemonic: count}} of the built library's probe
    kernels, from ``cuobjdump -sass``: which opcodes survived, for
    reading beside the timings (the k loop is unrolled by 4, with a
    remainder loop of single layers)."""
    from ..utils.cuda_build import sass_instructions

    out = {}
    for name, instructions in sass_instructions().items():
        m = re.search(r"probe_alu_kernelILi(\d+)E", name)
        if not m:
            continue
        counts: dict = {}
        for ins in instructions:
            op = ".".join(ins.split(".")[:2]) if ins.startswith(
                ("MUFU", "FSET", "FSETP")) else ins.split(".")[0]
            counts[op] = counts.get(op, 0) + 1
        out[VARIANTS[int(m.group(1))]] = counts
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("probe_alu_ops: torch sees no CUDA device", file=sys.stderr)
        return 1
    if "--sass" in argv:
        for v, counts in sass_counts().items():
            top = sorted(counts.items(), key=lambda kv: -kv[1])[:12]
            print(f"{v:10s} " + " ".join(f"{op}:{n}" for op, n in top))
        return 0
    rows = measure()
    print(f"{torch.cuda.get_device_name(0)}: ({B}, {CH}) f32 tile x {REPS} "
          f"repeats a launch, k = {K1} and {K2}")
    for v, r in rows.items():
        print(f"{v:10s} {r['ns_per_layer']:8.3f} ns/layer "
              f"({r['lanes_per_s'] / 1e12:6.3f} Tlanes/s) x {OPS[v]:2d} ops = "
              f"{r['share_of_peak']:6.1%} of the FP32 peak "
              f"[{r['ms_k1']:.4f} / {r['ms_k2']:.4f} ms]", flush=True)
    for v, r in rows.items():
        print(f"{v:10s} {r['x_fma']:5.2f}x fma")
    return 0


if __name__ == "__main__":
    sys.exit(main())
