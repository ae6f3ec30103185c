"""The benchmark of the PyTorch and CUDA port (``gnuais_tpu_torch``):
``python3 -m portbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``).
It imports the port, never JAX or the JAX package."""
