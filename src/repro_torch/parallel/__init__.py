"""Parallelism for the distributed SpGEMM: an in-process device mesh and
its collectives (``mesh``), and the operands' sharding (``sharding``).
The logical-axis rules and the pipeline of the LM stack are not ported."""
from . import mesh, sharding
from .mesh import Mesh, make_mesh, ppermute, psum, ring_all_to_all
from .sharding import (ShardedEll, put_spgemm_operands,
                       spgemm_operand_specs)

__all__ = ["Mesh", "ShardedEll", "make_mesh", "mesh", "ppermute", "psum",
           "put_spgemm_operands", "ring_all_to_all", "sharding",
           "spgemm_operand_specs"]
