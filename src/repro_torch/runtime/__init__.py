"""Port of ``repro/runtime``: the serving loop (``serve.py``), the train
step (``train.py``) and supervised training with checkpoint/restart
(``fault_tolerance.py``, with ``reshard``), and sharding on a
``DeviceMesh``: the logical-axis rules (``pspec.py``), the parameter,
state and batch rules (``sharding.py``), the sharded train steps
(``train.py``: ``jit_train_step``, ``make_compressed_dp_step``)."""
