"""portbench: the benchmark of ``kubetpu_torch`` on one NVIDIA H100.

``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything a cell
needs is found by name: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` and ``metrics/<metric>.py``.
"""
