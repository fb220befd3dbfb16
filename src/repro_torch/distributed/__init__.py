"""Multi-rank execution: logical sharding rules on a ``DeviceMesh``
(``sharding.py``) and the autograd-aware collectives the meshed model runs
on its local shards (``collectives.py``).  Port of ``repro/distributed``."""
