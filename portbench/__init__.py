"""Benchmark of the PyTorch + CUDA port (``orb_slam3_study_kr_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell sits in a file of its own that the harness finds by name:
``configs/<config>.yaml``, ``traffic/<traffic>.json`` (whose ``kind`` names
the driver in ``kinds/``), ``metrics/<metric>.py`` and
``limits/<workload>.json``.  The plain references under ``reference/``
import nothing of the port and nothing of JAX.
"""
