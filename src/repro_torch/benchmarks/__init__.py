"""repro_torch.benchmarks — the port's benchmarks (ports of the JAX
repo's ``benchmarks/serve_stream.py`` and ``benchmarks/chaos.py``), run as
``python -m repro_torch.benchmarks.<name>``.  Each keeps its own copy of
the harness's ``emit`` row format."""
