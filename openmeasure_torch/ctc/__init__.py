"""Computed tomography of chemiluminescence (CTC): voxel grids traced on the
device, unstructured meshes by the host caster, cameras, rigs and
resampling (port of ``openmeasure_tpu/ctc``)."""

from .grid import VoxelGrid
from .camera import camera
from .resample import resample_to_grid
from .raytrace import trace_rays
from .unstructured import UnstructuredMesh
from .projection import embed_projection, stack_cameras

__all__ = ["VoxelGrid", "UnstructuredMesh", "camera", "resample_to_grid",
           "trace_rays", "embed_projection", "stack_cameras"]
