"""Sharded execution over a mesh of devices (parallel/mesh.py) and its dry
run (parallel/dryrun.py)."""
