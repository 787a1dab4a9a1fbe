"""Measurement tools of the port, each runnable as a module:

    python -m particlesystem_tpu_torch.tools.probe_alu_ops
    python -m particlesystem_tpu_torch.tools.probe_two_shapes
"""
