"""Distribution layer: so far the seeded fault-injection harness
(``faultinject``); the heartbeats of ``ft`` and the sharding rules come
with the mesh (ROADMAP Queue 1, item 11)."""
