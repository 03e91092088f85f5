"""The JAX package's four example scripts (``examples/``), ported: each
runs as ``python -m repro_torch.examples.<name>`` with the JAX script's
flags plus ``--device`` (the CUDA device unless ``cpu`` is asked for),
takes its steps, configs and seeds, and prints its lines.

  quickstart       one train step with LSH off and on, and the wire tensor
  train_lm         ~100M-param MoE LM with checkpoints, resume, watchdog
  serve_batch      greedy decode of a batch of prompts on any arch
  elastic_restart  train, save, restore onto a new (1, 1) mesh, train on

Each exposes its config function (``build_config``) and ``run(...)``,
which the tests call with params made by the JAX package;
``main(argv=None)`` wraps them.
"""
