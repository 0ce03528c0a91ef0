"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` from the repository root runs one cell of ``BENCHMARK.json``.
Everything here is the yardstick: the graph generator, the plain
reference (``bench/reference``), the comparison that decides
``correct``, the trace reading and the per-layer metric readers
(``bench/metrics``).  Nothing in this package imports JAX or the JAX
package; ``bench/reference`` imports nothing of the port either.
"""
