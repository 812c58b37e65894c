"""Benchmark of ``repro_torch`` (the PyTorch and CUDA port) on NVIDIA GPUs.

``python -m chipbench.run --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``: a model configuration under a
traffic mix, served through ``repro_torch.api.Session``.  Everything that
belongs to one configuration, traffic mix, metric or reference lives in files
of its own that the harness finds by name:

* ``configs/<config>.json``: the model's sizes as run (``model``, whose
  ``family`` names the two files below), and the source's own under its
  ``config.json`` names (``published``), which a CPU test holds the port's
  config to;
* ``traffic/<traffic>.json``: the load (loop, batch, clients, lengths);
* ``checks/<workload>.json``: the output check's sample and limit;
* ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``;
* ``families/<family>.py``: the family's ``layer_groups(model)``, its weight
  ``layout(model)`` (the port's tree of (shape, init) leaves), the work of a
  request ``request_flops(model, prompt_len, gen)``, ``PUBLISHED`` (how each
  key of a ``published`` block reads off the port's config) and, where it
  has fills of its own, ``INITS``;
* ``reference/<family>.py``: the plain PyTorch forward the outputs are held to.

Nothing here imports ``jax`` or the JAX package ``repro``; the families and
the references import nothing of ``repro_torch`` either.
"""
