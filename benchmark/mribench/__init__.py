"""The benchmark's harness for ``mridc_tpu_torch``: cells from
``BENCHMARK.json``, traffic from the mix files, seeded weights and inputs,
the timed windows, the trace readers, and the comparison with the plain
references that decides ``correct``."""
