"""Measurement tools of the port, each runnable as a module:

    python -m particlesystem_tpu_torch.tools.probe_alu_ops
    python -m particlesystem_tpu_torch.tools.probe_two_shapes
    python -m particlesystem_tpu_torch.tools.sweep_pair_kernel
    python -m particlesystem_tpu_torch.tools.parity_horizon
    python -m particlesystem_tpu_torch.tools.measure_batched_run
    python -m particlesystem_tpu_torch.tools.measure_ckpt_10m
    python -m particlesystem_tpu_torch.tools.multihost_worker  (one rank
        of a launched run; see its docstring)
"""
