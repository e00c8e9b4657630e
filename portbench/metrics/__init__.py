"""One reader a metric, found by the metric's name: ``read(run)`` returns
the number or None when the run has nothing to read."""
