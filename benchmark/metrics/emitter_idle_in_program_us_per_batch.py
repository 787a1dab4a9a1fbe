"""Device-idle microseconds a batch inside the program's own spans
(``PackedEngine.step_many``'s ``engine.batch``, its hand-in included),
over the batches the window completed; the reader of
``nbody_idle_in_program_us_per_run``."""

from .nbody_idle_in_program_us_per_run import read  # noqa: F401
