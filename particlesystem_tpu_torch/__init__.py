"""particlesystem_tpu_torch — the particle simulation in PyTorch and CUDA.

The port of ``particlesystem_tpu`` (JAX, XLA and Pallas on a TPU) to
PyTorch on an NVIDIA Hopper GPU.  Plain tensor code is PyTorch; the TPU's
Pallas kernels become CUDA kernels under ``csrc/``, each with a plain
PyTorch version beside it that CPU tensors take.  The JAX package stays the
reference the port is tested against; this package never imports JAX.
"""

from .api import NBodySimulation, ParticleSystem
from .core import (Emitter, EmitterSceneConfig, GridSpec, NBodyConfig,
                   ParticleState, PlaneCollider, SphereCollider, zero_state)
from .runtime.engine import PackedEngine

__version__ = "0.1.0"

__all__ = [
    "Emitter", "EmitterSceneConfig", "GridSpec", "NBodyConfig",
    "NBodySimulation", "PackedEngine", "ParticleState", "ParticleSystem",
    "PlaneCollider", "SphereCollider", "zero_state", "__version__",
]
