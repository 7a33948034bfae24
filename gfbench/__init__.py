"""The benchmark of openmmgridforce_tpu_torch: see README.md."""
