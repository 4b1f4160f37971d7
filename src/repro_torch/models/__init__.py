"""Port of ``repro/models``: the dense decoder block of this slice
(``transformer.DenseBlock``), its layers and the JAX-parameter converter."""
