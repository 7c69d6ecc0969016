"""Device meshes for the sharded decode, the cross-pod train step and the
production mesh with its placements (``mesh``); the roofline and the dry
run (``roofline``, ``dryrun``)."""

from .mesh import (AbstractMesh, DecodeMesh, Placement,  # noqa: F401
                   data_axes, make_decode_mesh, make_pod_mesh,
                   make_production_mesh, make_smoke_mesh)
