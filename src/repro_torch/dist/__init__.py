"""Distribution layer: the collectives over ``torch.distributed``
(``comm``), the logical sharding rules (``sharding``), the seeded
fault-injection harness (``faultinject``) and the worker heartbeats with
stall detection (``ft``). The meshes themselves are in
``repro_torch.launch.mesh``."""
