"""Parallelism: an in-process device mesh of any number of axes and its
collectives (``mesh``), the distributed SpGEMM operands' sharding
(``sharding``) and the GPipe pipeline over one mesh axis (``pipeline``).
The logical-axis rules of the LM stack are not ported."""
from . import mesh, pipeline, sharding
from .mesh import Mesh, make_mesh, ppermute, psum, ring_all_to_all
from .pipeline import pipeline_apply
from .sharding import (ShardedEll, put_spgemm_operands,
                       spgemm_operand_specs)

__all__ = ["Mesh", "ShardedEll", "make_mesh", "mesh", "pipeline",
           "pipeline_apply", "ppermute", "psum",
           "put_spgemm_operands", "ring_all_to_all", "sharding",
           "spgemm_operand_specs"]
