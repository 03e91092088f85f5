"""Measured tuning of the comm planner (counterpart of ``repro/tune/``).

  probe        timed runs of the production collectives on the live mesh
               (transport x message-size ladder x wire format, and the
               kernel ops): warm-up, then a trimmed mean
  fingerprint  the mesh, topology and software facts that key the results
  cache        the persistent JSON cache (~/.cache/repro-tune, or
               $REPRO_TUNE_CACHE), written atomically, an entry of another
               fingerprint rejected
  model        ``CalibratedCostModel``: per-hop link constants fitted to
               the probe rows, behind ``topology.a2a_cost`` /
               ``CommPlan.wire_cost``
  runtime      what the planner reads (CommConfig.tuning > $REPRO_TUNE >
               off; a miss keeps the static constants)
  autotune     probe, fit, store: ``autotune(mesh, comm)`` and the CLI
               ``python -m repro_torch.tune``
"""
