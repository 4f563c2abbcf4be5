"""The benchmark of point_cloud_registration_tpu_torch: ``perfbench/run.py``."""
