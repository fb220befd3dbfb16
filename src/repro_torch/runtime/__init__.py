"""Runtime policy around the serving step (port of ``repro/runtime``)."""
