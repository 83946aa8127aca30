"""The benchmark of raytracer2_tpu_torch on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the repository root names each cell as a configuration
(configs/<name>.json) under a traffic mix (traffic/<name>.json); each
per-layer metric is a reader of its own (metrics/<name>.py) and each
cell's correctness limits are limits/<cell>.json. The plain reference
that decides `correct` is reference/, which imports nothing of the
program.
"""
