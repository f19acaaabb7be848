"""The benchmark of faststyle_tpu_torch, the PyTorch/CUDA port, on one H100.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See README.md for its parts and how a later change adds to them.
"""
