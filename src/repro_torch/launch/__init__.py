"""Port of ``repro/launch``: the training launcher (``train.py``), the
production plans (``plans.py``), the one-card dry run (``dryrun.py``) and
its report (``report.py``).  The production meshes and ``obsreport`` wait
for ``ROADMAP.md`` queue 1 items 10 and 11."""
