"""cardbench: the benchmark of ``ranking_tpu_torch`` on one NVIDIA H100.

``python -m cardbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
result line. Each configuration (``configs/``), traffic mix (``traffic/``),
per-layer metric (``metrics/``) and set of correctness limits (``limits/``)
is a file of its own, found by the name that ``BENCHMARK.json`` gives it.
Nothing here imports ``jax`` or the JAX package; ``reference/`` imports
nothing of the port either.
"""
