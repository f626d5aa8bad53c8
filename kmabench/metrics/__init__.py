"""One reader a per-layer metric: ``read(res)`` returns its value, or
None where the run holds nothing to read."""
