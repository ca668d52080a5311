"""The benchmark of ``torrent_tpu_torch`` (the PyTorch and CUDA port).

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything that belongs to one configuration, traffic
mix, driver or per-layer metric is a file of its own, found by name:

- ``benchmark/configs/<config>.json``: the deployment's sizes, source,
  cuts (``reduced``), assumptions and guarantees;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters and the
  driver that generates it;
- ``benchmark/drivers/<driver>.py``: one general generator per kind of
  traffic;
- ``benchmark/layer_metrics/<metric>.py``: one reader per per-layer metric.

``benchmark/reference/`` is the plain reference and the frozen yardstick.
Nothing here imports JAX or the JAX package.
"""
