"""The benchmark of ``alink_tpu_torch`` on an NVIDIA H100.

Run a cell of ``BENCHMARK.json`` from the root of a checkout:

    python3 bench_torch/run.py --workload serve_r100_typical --seed 7 \
        --seconds 30 --trace 0

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it: ``configs/<config>.json`` (sizes, precision, limits; its
``system`` names a module of ``systems/``), ``traffic/<traffic>.json``
(parameters; its ``driver`` names a module of ``drivers/``) and
``metrics/<metric>.py`` (a reader with ``read(run) -> float | None``).
The yardstick (``stats``, ``roofline``, ``tracing``, ``reference/``) is
shared by every cell and imports nothing of the program.
"""
