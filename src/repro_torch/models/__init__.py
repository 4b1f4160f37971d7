"""Port of ``repro/models``: the dense decoder block of slice 1
(``transformer.DenseBlock``), the RG-LRU sublayer of slice 2
(``transformer.RecurrentSublayer``, ``rglru``), their layers and the
JAX-parameter converters."""
