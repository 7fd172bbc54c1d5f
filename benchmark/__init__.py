"""The benchmark of tensorflow_nufft_tpu_torch (the PyTorch and CUDA port).

``run.py`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything that belongs to one configuration, traffic mix, entry
kind or metric lives in a file of its own, found by its name:

- ``configs/<config>.json``: the deployment's sizes and guarantees;
- ``traffic/<traffic>.json``: the traffic mix, read by ``traffic.py``;
- ``entries/<kind>.py``: the code of one kind of timed call;
- ``metrics/<metric>.json``: which reader in ``readers/`` computes a
  metric, and from what;
- ``limits/<cell>.json``: the limit of each number compared against the
  plain reference (``reference/``) that decides ``correct``.

Nothing here imports JAX or the JAX package ``tensorflow_nufft_tpu``.
"""
