from .mesh import make_mesh, allreduce_or, sharded_sketch_step, make_tiles  # noqa: F401
