"""The benchmark of the PyTorch / CUDA port (``cut3r_slam_tpu_torch``) on
an NVIDIA H100: ``python3 -m port_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. The cells, configurations and metrics are
named in the repository's ``BENCHMARK.json``; ``harness.py`` says where
each is found. Nothing here imports JAX or the JAX package."""
