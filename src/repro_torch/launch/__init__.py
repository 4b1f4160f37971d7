"""Port of ``repro/launch``: the training launcher (``train.py``), the
production plans (``plans.py``), the dry run on one card or the
production meshes (``dryrun.py``), its report (``report.py``), the trace
report (``obsreport.py``) and the meshes (``mesh.py``: the 256- and
512-rank production meshes on a fake process group, the host's ranks, a
mesh destination's ranks)."""
