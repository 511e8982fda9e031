"""The benchmark of needle_tpu_torch, the PyTorch and CUDA port of
needle-tpu: `python3 -m needle_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout (see README.md).

It imports nothing of jax or of the JAX package, and of the port only the
system under test (`Analyzer`, `Comparator`), its spans and counters and
the count walk's launch function. The plain reference (`reference/`) and
the season writer (`data/`) import nothing of the port.
"""
