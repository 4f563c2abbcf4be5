"""Host-side utilities: point-cloud IO, phase timing and profiler traces, and
the conversion of the JAX package's state."""

from point_cloud_registration_tpu_torch.utils.diagnostics import PhaseTimer, profiler_trace
from point_cloud_registration_tpu_torch.utils.io import read_pcd, read_pcd_xyz, write_pcd

__all__ = ["PhaseTimer", "profiler_trace", "read_pcd", "read_pcd_xyz", "write_pcd"]
