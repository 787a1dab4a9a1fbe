"""Particle state as a dataclass of tensors (structure of arrays).

Counterpart of ``particlesystem_tpu/core/state.py``.  The reference stores
particles as a 72-byte array-of-structs (``P_DATA_TYPE``,
the reference's ``source/code/inc/common.h:94-120``) inside a segmented
container whose slot index encodes spatial ownership; here it is a flat SoA
of tensors with a static slot count, and cells are recomputed from
positions each frame.

The reference's snapshot buffer ``T_DATA_TYPE`` (``common.h:122-132``) is
implicit: a step reads its input state and returns a new one.

``tag`` holds uint32 values in an int64 tensor (torch has no CPU ``arange``
for ``uint32``); :func:`state_from_numpy` / :func:`state_to_numpy` convert
from and to the JAX package's leaves, with uint32 tags on the numpy side.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

FIELDS = ("pos", "vel", "acc", "w", "age", "life", "alive", "parent", "tag")


@dataclasses.dataclass
class ParticleState:
    """SoA particle store with ``slots`` fixed-capacity rows.

    * ``pos``/``vel``/``acc`` — float32 ``(N, 3)``
    * ``w``, ``age``, ``life`` — float32 ``(N,)`` (``life`` is the
      fertility age in the n-body scene)
    * ``alive``, ``parent`` — bool ``(N,)``
    * ``tag`` — persistent per-particle identity, uint32 values in int64;
      all per-particle randomness and the collision order key on it.
    """

    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    w: torch.Tensor
    age: torch.Tensor
    life: torch.Tensor
    alive: torch.Tensor
    parent: torch.Tensor
    tag: torch.Tensor

    @property
    def slots(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @property
    def num_alive(self) -> torch.Tensor:
        """Alive rows, as a 0-dim int32 device tensor."""
        return self.alive.sum(dtype=torch.int32)

    def to(self, device) -> "ParticleState":
        return self.map(lambda a: a.to(device))

    def map(self, fn) -> "ParticleState":
        """Apply ``fn`` to every field tensor."""
        return ParticleState(**{f: fn(getattr(self, f)) for f in FIELDS})


def zero_state(slots: int, device) -> ParticleState:
    """All-dead state (INIT_PARTICLES, ``particleSystem.cpp:703-753``)."""
    f = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    b = lambda: torch.zeros((slots,), dtype=torch.bool, device=device)
    return ParticleState(
        pos=f(slots, 3), vel=f(slots, 3), acc=f(slots, 3),
        w=f(slots), age=f(slots), life=f(slots),
        alive=b(), parent=b(),
        tag=torch.zeros((slots,), dtype=torch.int64, device=device),
    )


def pack_state(state: ParticleState):
    """Eight per-field ``(N,)`` float32 views (x, y, z, vx, vy, vz, age,
    life): the layout the emitter engine's physics kernel streams."""
    return (state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
            state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
            state.age, state.life)


def unpack_state(packed, template: Optional[ParticleState] = None
                 ) -> ParticleState:
    """Inverse of :func:`pack_state`; ``acc``, ``w``, ``parent`` and ``tag``
    come from ``template`` (all zero without one).  ``alive`` is derived as
    ``age <= life`` and ``life > 0`` (the emitter-scene convention)."""
    age, life = packed[6], packed[7]
    if template is None:
        template = zero_state(age.shape[0], age.device)
    return dataclasses.replace(
        template, pos=torch.stack(packed[0:3], dim=1),
        vel=torch.stack(packed[3:6], dim=1), age=age, life=life,
        alive=(age <= life) & (life > 0))


def state_from_numpy(arrays: Dict[str, np.ndarray], device) -> ParticleState:
    """Build a state from numpy arrays keyed by field name (e.g. the JAX
    ``ParticleState`` leaves taken with ``np.asarray``)."""
    dtypes = dict(tag=np.int64, alive=np.bool_, parent=np.bool_)
    out = {}
    for f in FIELDS:
        a = np.asarray(arrays[f])
        if f == "tag":
            a = a.astype(np.uint32)
        out[f] = torch.tensor(a.astype(dtypes.get(f, np.float32)),
                              device=device)
    return ParticleState(**out)


def state_to_numpy(state: ParticleState) -> Dict[str, np.ndarray]:
    """Inverse of :func:`state_from_numpy`; tags come back as uint32.  The
    arrays are a snapshot, never views of the state's tensors: the frame
    loops write their states in place."""
    out = {}
    for f in FIELDS:
        t = getattr(state, f).detach()
        a = t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
        out[f] = a.astype(np.uint32) if f == "tag" else a
    return out
