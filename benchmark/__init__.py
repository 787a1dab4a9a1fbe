"""The benchmark of ``particlesystem_tpu_torch`` on one NVIDIA card.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line.  Everything is found by name: a cell's configuration in the file
``BENCHMARK.json`` names, its traffic in ``traffic/<mix>.json`` (whose
``driver`` names the module of ``drivers/`` that generates it), its
comparison's limits in ``workloads/<cell>.json``, and each metric's reader
in ``metrics/<metric>.py``.  The plain reference the outputs are held to
is ``reference/``.
"""
