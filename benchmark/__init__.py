"""The benchmark of ``tpufluid_torch`` on an NVIDIA H100 (see
``benchmark/run.py`` and ``BENCHMARK.json``)."""
