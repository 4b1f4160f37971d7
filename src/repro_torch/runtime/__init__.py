"""Port of ``repro/runtime``: the serving loop (``serve.py``).  Training,
fault tolerance and sharding come with later slices."""
