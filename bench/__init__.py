"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One run measures one cell of ``BENCHMARK.json``:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives
it: ``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py``, ``limits/<cell>.json``; a configuration names
its FLOP and byte arithmetic (``work/<name>.py``) and its plain reference
(``reference/<name>.py``), and a traffic mix its runner
(``drive_<kind>.py``).  Nothing here imports ``jax`` or the JAX package
``repro``; the plain reference imports nothing of ``repro_torch`` either.
"""
