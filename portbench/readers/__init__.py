"""One reader a metric: ``readers/<metric name>.py`` with ``read(run)``."""
