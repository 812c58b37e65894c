"""Benchmark of ``repro_torch`` (the PyTorch and CUDA port) on NVIDIA GPUs.

``python -m chipbench.run --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``: a model configuration under a
traffic mix, served through ``repro_torch.api.Session``.  Everything that
belongs to one configuration, traffic mix, metric or reference lives in files
of its own that the harness finds by name:

* ``configs/<config>.json``: the model's sizes as run;
* ``traffic/<traffic>.json``: the load (loop, batch, clients, lengths);
* ``checks/<workload>.json``: the output check's sample and limit;
* ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``;
* ``reference/<family>.py``: the plain PyTorch forward the outputs are held to.

Nothing here imports ``jax`` or the JAX package ``repro``; the reference
imports nothing of ``repro_torch`` either.
"""
