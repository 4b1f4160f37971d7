"""Port of ``repro/launch``: the training launcher (``train.py``).  The
dry-run, report and plan launchers wait for ``ROADMAP.md`` queue 1
item 11."""
