"""The benchmark of the PyTorch/CUDA port (``tpujob_torch``) on one NVIDIA
H100: training through ``tpujob_torch.workloads.bert.train``.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
per-layer metric or cell is a file of its own, found by its name:

- ``configs/<config>.json``: the model as it is run, its source and its
  departures; ``references/<reference>.py`` beside it is the plain model.
- ``traffic/<traffic>.json``: batch, lengths, token law, masking,
  optimizer schedule, the calls of set-up, of the check and of the trace.
- ``objectives/<objective>.py``: how the port trains on such a batch (its
  module, loss and batch tuple) and the reference's loss of it.
- ``metrics/<metric>.py``: a per-layer metric's reader of the trace.
- ``limits/<workload>.json``: the numbers ``correct`` compares, each with
  its limit and the readings it was set from.

Nothing here imports ``jax``, ``flax`` or the JAX package ``tpujob``; the
reference and the yardstick import nothing of ``tpujob_torch``.
"""
