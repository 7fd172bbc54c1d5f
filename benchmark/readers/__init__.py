"""Metric readers, one module each, found by the ``reader`` named in
``metrics/<metric>.json``. ``read(definition, run)`` returns the
metric's value (a dict with ``value`` and, where it says more, further
keys), or None where the run holds nothing to read: the metric is then
left out of the result, never reported as 0."""
