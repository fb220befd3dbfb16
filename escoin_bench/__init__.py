"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one card.

``run.py`` is the one command.  Everything that belongs to one
configuration, one cell or one per-layer metric lives in a file of its own
that the harness finds by the name ``BENCHMARK.json`` gives it:

  configs/<config>.json     the network as it is run: its layer table, the
                            port's network and plan, the published source
  workloads/<cell>.json     one cell: its config, driver, traffic and limits
  drivers/<driver>.py       one kind of traffic (``run(ctx) -> Run``)
  metrics/<metric>.py       one per-layer metric (``read(run) -> value``)
  reference/<family>.py     the plain reference of a family of networks
  systems/<family>.py       how the port is built for that family

The yardstick (work counts, peaks, the comparison that decides ``correct``)
lives here too, so that a change to the program cannot move it.
"""
