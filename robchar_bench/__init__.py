"""The benchmark of code_robchar_tpu_torch on one H100: ``python3 -m
robchar_bench.run``, driven by BENCHMARK.json (harness.py)."""
