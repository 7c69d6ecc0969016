"""Device meshes for the sharded decode and the cross-pod train step
(``mesh``)."""

from .mesh import (DecodeMesh, make_decode_mesh, make_pod_mesh,  # noqa: F401
                   make_smoke_mesh)
