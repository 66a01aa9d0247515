"""The benchmark of the PyTorch / CUDA port (``iclr_17_compression_tpu_torch``).

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once: it builds the
cell's inputs and weights from the seed, warms up, measures for the given
seconds, checks what the timed path produced against the plain reference
in ``reference/``, and prints one JSON line. See ``harness.py``.
"""
