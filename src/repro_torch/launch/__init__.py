"""Port of ``repro/launch``: the training launcher (``train.py``), the
production plans (``plans.py``), the one-card dry run (``dryrun.py``), its
report (``report.py``) and the trace report (``obsreport.py``).  The
production meshes wait for ``ROADMAP.md`` queue 1 item 10."""
