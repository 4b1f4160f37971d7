"""Port of ``repro/configs`` (the dense configuration fields and the
``qwen3_0_6b`` config, the model of this slice)."""
