"""The port's benchmark: one cell of BENCHMARK.json a run (``python3 -m
portbench.run``); README.md says how it is laid out."""
