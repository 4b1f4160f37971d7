"""Port of ``repro/configs`` (the dense, hybrid and RWKV configuration
fields, and the ``qwen3_0_6b``, ``recurrentgemma_2b`` and ``rwkv6_3b``
configs, the models of slices 1 and 2)."""
