"""Force stack and contact response for emitter scenes, on ``(N, 3)``
tensors.

Counterpart of ``particlesystem_tpu/ops/forces.py``, used by the reference
step ``models/emitter.step_core``:

* acceleration  ``a = g + (wind - v) * drag``
* semi-implicit Euler: ``v' = v + a*dt``;  ``p' = p + v'*dt``
* plane contact (signed distance ``d = dot(p'-point, n) < 0``): the position
  is projected back to the surface, the inbound normal velocity is reflected
  and scaled by restitution, the tangential velocity scaled by
  ``(1 - friction)``;
* sphere contact (``|p'-c| < r``): the same response along the outward
  radial normal.

Every scene constant is rounded to float32 before it meets a tensor, as the
JAX package's weakly typed Python scalars are.
"""

from __future__ import annotations

import torch

from ..core.config import EmitterSceneConfig
from .neighbor import as_f32

EPS_DIST = as_f32(1e-20)  # floor of a sphere-contact distance before dividing


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device: taken in
    float64 and rounded once (torch's CPU float32 ``sqrt`` can be one ulp
    off it; CUDA's ``__fsqrt_rn`` is exactly it)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def accel(vel: torch.Tensor, cfg: EmitterSceneConfig) -> torch.Tensor:
    a = vel.new_tensor(cfg.gravity).expand(vel.shape)
    if cfg.drag:
        a = a + (vel.new_tensor(cfg.wind) - vel) * as_f32(cfg.drag)
    return a


def _respond(pos, vel, n, depth, restitution, friction):
    """Shared contact response: push out along ``n`` by ``depth`` where
    ``depth > 0``, reflect the inbound normal velocity."""
    contact = depth > 0
    pos = torch.where(contact[:, None], pos + n * depth[:, None], pos)
    vn = torch.sum(vel * n, dim=1)
    inbound = contact & (vn < 0)
    vnn = n * vn[:, None]
    vt = vel - vnn
    new_vel = vt * as_f32(1.0 - friction) - vnn * as_f32(restitution)
    return pos, torch.where(inbound[:, None], new_vel, vel)


def collide(pos: torch.Tensor, vel: torch.Tensor, cfg: EmitterSceneConfig):
    for pl in cfg.planes:
        n = pos.new_tensor(pl.normal)
        n = n / sqrt_f32(torch.sum(n * n))
        d = torch.sum((pos - pos.new_tensor(pl.point)) * n, dim=1)
        pos, vel = _respond(pos, vel, n, -d, pl.restitution, pl.friction)
    for sp in cfg.spheres:
        dvec = pos - pos.new_tensor(sp.center)
        dist = sqrt_f32(torch.sum(dvec * dvec, dim=1))
        n = dvec / torch.clamp(dist, min=EPS_DIST)[:, None]
        pos, vel = _respond(pos, vel, n, as_f32(sp.radius) - dist,
                            sp.restitution, sp.friction)
    return pos, vel
