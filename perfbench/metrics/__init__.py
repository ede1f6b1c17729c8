"""One reader a metric, ``<metric>.py`` with ``read(record)``, found by
the metric's name in ``BENCHMARK.json`` (``perfbench.harness.reader``)."""
