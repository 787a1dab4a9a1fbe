"""One built kernel, several shapes, interleaved: is that safe on the card?

Counterpart of ``tools/probe_same_pallas_two_sigs.py``.  The JAX tool asks
whether one Pallas kernel of a constant shape may sit inside two jit
signatures; here the kernel is a built CUDA function that takes its width
at run time, and the question becomes the one ``NBodySimulation``'s
re-bucketing relies on: callers of different widths launch the same kernel
in turn, at a fixed padded shape and at their own shapes, and every result
must be right.

:func:`probe_affine` computes ``x * 2 + 1`` over a (16, width) float32
array: the CUDA kernel (``csrc/probe_affine.cu``) for a CUDA tensor,
:func:`probe_affine_plain` for a CPU one.  The kernel rounds once (one
FFMA), the plain version twice; ``x * 2`` is exact, so both give the same
bits.

``main()`` drives two callers of widths 512 and 768 for ten frames, each
frame through :func:`step_bucket` (pad to (16, 1024), launch, slice, add
the frame) and :func:`step_bucket_var` (launch at (16, width)), checks
every value (``3 + frame`` on an input of ones) and prints ``SAFE``.

Usage: python -m particlesystem_tpu_torch.tools.probe_two_shapes
"""

from __future__ import annotations

import sys

import torch

from ..utils import cuda_build
from ..utils.cuda_build import by_device, launch

ROWS = 16
CAP = 1024   # the constant padded width
WIDTHS = (512, 768)
FRAMES = 10


def probe_affine_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    return x * 2.0 + 1.0


def probe_affine_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream."""
    if (x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != ROWS
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous float32 ({ROWS}, width) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    launch("ps_probe_affine", x.device, x.data_ptr(), out.data_ptr(),
           x.numel())
    return out


def probe_affine(x: torch.Tensor) -> torch.Tensor:
    """``x * 2 + 1``: the kernel for a CUDA tensor, the plain version for a
    CPU one."""
    return by_device(x, "affine kernel", probe_affine_cuda,
                     probe_affine_plain)(x)


def step_bucket(x: torch.Tensor, frame: int) -> torch.Tensor:
    """A caller of width ``x.shape[1]`` around the kernel at the constant
    (16, CAP) shape: pad, launch, slice, add the frame."""
    width = x.shape[1]
    full = torch.cat([x, x.new_zeros((ROWS, CAP - width))], dim=1)
    return probe_affine(full)[:, :width] + float(frame)


def step_bucket_var(x: torch.Tensor, frame: int) -> torch.Tensor:
    """The same caller with the kernel at its own (16, width) shape."""
    return probe_affine(x) + float(frame)


def run(device) -> int:
    """Ten interleaved frames of both callers through both paths; raises on
    a wrong value.  Returns the number of kernel results checked."""
    xs = [torch.ones((ROWS, w), dtype=torch.float32, device=device)
          for w in WIDTHS]
    checked = 0
    for frame in range(FRAMES):
        # bucket A twice, bucket B twice, then back and forth
        x = xs[0] if frame < 2 else xs[1] if frame < 4 else xs[frame % 2]
        for step in (step_bucket, step_bucket_var):
            got = step(x, frame)
            if got.shape != x.shape or not bool((got == 3.0 + frame).all()):
                raise AssertionError(
                    f"{step.__name__} width {x.shape[1]} frame {frame}: "
                    f"got {got.flatten()[0].item()}, expected {3.0 + frame}")
            checked += 1
        if frame == 1:
            print(f"bucket A ({WIDTHS[0]}) launched twice: ok", flush=True)
        if frame == 3:
            print(f"bucket B ({WIDTHS[1]}) launched twice: ok", flush=True)
    return checked


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("probe_two_shapes: torch sees no CUDA device", file=sys.stderr)
        return 1
    before = cuda_build.launches().get("ps_probe_affine", 0)
    checked = run(torch.device("cuda", 0))
    torch.cuda.synchronize()
    print(f"SAFE on {torch.cuda.get_device_name(0)}: one built kernel at the "
          f"fixed (16, {CAP}) shape from callers of widths {WIDTHS} and at "
          f"their own shapes, interleaved for {FRAMES} frames, "
          f"{cuda_build.launches()['ps_probe_affine'] - before} launches, "
          f"{checked} results correct", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
