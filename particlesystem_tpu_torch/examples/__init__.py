"""Examples of the port, each runnable as a module:

    python -m particlesystem_tpu_torch.examples.fountain_render [out_dir] [n_frames]
    python -m particlesystem_tpu_torch.examples.nbody_demo [n_fill] [iters]

Both run on the card unless given ``--device cpu``.
"""
