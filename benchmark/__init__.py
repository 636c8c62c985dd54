"""The benchmark of ``tinman_sandbox_tpu_torch``: one cell a run.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells; each cell's
configuration, traffic mix, per-layer metrics and correctness limits are
files under this folder, found by name (``spec.py``).
"""
