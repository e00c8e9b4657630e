"""The benchmark of ``toyslam_tpu_torch`` on an NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json`` and
each metric's reader in ``metrics/<metric>.py``.
"""
