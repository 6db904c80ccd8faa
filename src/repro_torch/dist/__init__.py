"""Distribution layer: the seeded fault-injection harness (``faultinject``)
and the worker heartbeats with stall detection (``ft``); the sharding
rules come with the mesh (ROADMAP Queue 1, item 11)."""
