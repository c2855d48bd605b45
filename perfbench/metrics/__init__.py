"""One reader a per-layer metric, ``<metric>.py`` with ``read(ctx)``:
the harness loads it by the metric's name."""
