"""Parallelism: an in-process device mesh of any number of axes and its
collectives (``mesh``), the logical-axis sharding rules of the LM stack,
the tensors the partitioned serving program lays out by them
(``Sharded``) and the distributed SpGEMM operands' sharding
(``sharding``), and the GPipe pipeline over one mesh axis
(``pipeline``)."""
from . import mesh, pipeline, sharding
from .mesh import Mesh, make_mesh, ppermute, psum, ring_all_to_all
from .pipeline import pipeline_apply
from .sharding import (DEFAULT_RULES, NamedSharding, Sharded, ShardedEll,
                       ShardingRules, current_rules, put_spgemm_operands,
                       sharding_rules, spgemm_operand_specs)

__all__ = ["DEFAULT_RULES", "Mesh", "NamedSharding", "Sharded", "ShardedEll",
           "ShardingRules", "current_rules", "make_mesh", "mesh", "pipeline",
           "pipeline_apply", "ppermute", "psum", "put_spgemm_operands",
           "ring_all_to_all", "sharding", "sharding_rules",
           "spgemm_operand_specs"]
