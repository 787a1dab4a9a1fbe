from .config import (Emitter, EmitterSceneConfig, GridSpec, NBodyConfig,
                     PlaneCollider, SphereCollider)
from .state import ParticleState, zero_state

__all__ = ["Emitter", "EmitterSceneConfig", "GridSpec", "NBodyConfig",
           "ParticleState", "PlaneCollider", "SphereCollider", "zero_state"]
