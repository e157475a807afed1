"""One reader a per-layer metric, by the metric's name.  ``read(rec)``
takes the traced run's records (``drive_train.records``) and returns the
metric's value, or None where it finds nothing to read."""
