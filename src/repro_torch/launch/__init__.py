"""Device meshes for the sharded decode (``mesh``)."""

from .mesh import DecodeMesh, make_decode_mesh, make_smoke_mesh  # noqa: F401
