"""Port of ``repro/runtime``: the serving loop (``serve.py``), the train
step (``train.py``) and supervised training with checkpoint/restart
(``fault_tolerance.py``).  Sharding waits for the mesh (``ROADMAP.md``
queue 1 item 10)."""
