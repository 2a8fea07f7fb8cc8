"""SPLIM reproduction in PyTorch + CUDA for one NVIDIA H100.

The port of ``repro`` (the JAX/Pallas reference, which it never imports).
Its slices so far carry the single-device SpGEMM, cold and warm:

    import repro_torch
    a = repro_torch.ell_rows_from_dense(A, k_a)        # on CUDA by default
    b = repro_torch.ell_cols_from_dense(B, k_b)
    c = repro_torch.spgemm(a, b)                       # 'sort' accumulation
    c = repro_torch.spgemm(a, b, accumulator="search") # the paper's Alg. 1
    c = repro_torch.spgemm(a, b, accumulator="stream") # never materialized
    st = repro_torch.make_structure(a, b, backend="sort")  # symbolic, once
    c = repro_torch.spgemm(a, b, structure=st)         # numeric, each call

with the backend chosen by the planner (``accumulator="auto"``, fitted to
the H100 on CUDA operands) or by measurement
(``StructureCache(autotune=True)``), and the SpMM side: pruned weights as
N:M planes or ELLPACK, and the MoE layer whose top-k routing is a row-wise
ELLPACK matrix:

    lyr = repro_torch.SparseLinear(w, 0.5, nm=(2, 4))  # K10 on x @ W
    mlp = repro_torch.SparseMLP(w_in, w_out, 0.5, nm=(2, 4))
    y, aux = repro_torch.moe_apply(p, x, cfg, torch.float32)  # K9 twice

the hybrid ELLPACK + COO format (``repro_torch.hybrid``:
``split_rows_hybrid``, ``split_cols_hybrid``, ``hybrid_spgemm_dense``),
the distributed SpGEMM on an in-process device mesh:

    mesh = repro_torch.parallel.make_mesh((4,), ("x",))   # 4 shards, 1 card
    c = repro_torch.spgemm(a, b, mesh=mesh, axis="x")      # 'ring' | 'cstat'
    dp = repro_torch.make_dist_plan(a, b, n_dev=4)         #   | 'summa'

the serving engine's SpGEMM lane:

    eng = repro_torch.ServingEngine(None, None, repro_torch.ServeConfig())
    rid = eng.submit_spgemm(a, b)                      # queued request
    c = eng.flush_spgemm()[rid]                        # waves of slots
    eng.stats()                                        # occupancy, latency

and the LM stack's token serving (the decoder families built on attention;
``python -m repro_torch.launch.serve --arch <id>`` runs it):

    model = repro_torch.build_model(repro_torch.configs.get_config(arch))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    eng = repro_torch.ServingEngine(model, params, repro_torch.ServeConfig())
    outs = eng.generate_batch(prompts)                 # prefill + decode

and training on it (``python -m repro_torch.launch.train --arch <id>``):

    trainer = repro_torch.runtime.Trainer(model, repro_torch.runtime
                                          .TrainerConfig(steps=100))
    out = trainer.run()                                # AdamW, checkpoints

Constructors default to ``default_device()`` (CUDA, or an error); pass
``device="cpu"`` to run the kernels' plain torch versions on the CPU. The
CUDA kernels build from ``src/repro_torch/csrc`` on first use.
``repro_torch.obs.enable()`` turns on the spans and counters the entry points
report through (``obs.export_chrome(path)`` writes a Chrome trace).
"""
from . import checkpoint, configs, core, data, kernels, launch, models, \
    obs, optim, parallel, plan, runtime, serve
from .core import hwmodel, hybrid, sccp
from .core.accumulate import AccumulatorOverflow, check_no_overflow
from .core.api import spgemm
from .core.formats import (Coo, EllCols, EllRows, coo_from_dense,
                           default_device, ell_cols_from_dense,
                           ell_rows_from_dense, from_numpy, nm_from_numpy,
                           np_ell_cols_from_scipy, np_ell_rows_from_scipy,
                           params_from_numpy, to_numpy)
from .core.nm import NmWeights, detect_nm, nm_from_dense
from .core.sccp import count_products
from .core.spgemm import spgemm_dense
from .kernels.nm_spmm import nm_spmm
from .models import (Model, SparseLinear, SparseMLP, build_model,
                     magnitude_prune, magnitude_prune_nm, moe_apply)
from .plan import (DistPlan, Plan, SpgemmStructure, StructureCache,
                   fingerprint, make_dist_plan, make_plan, make_structure,
                   make_structure_batched, plan_spmm_format)
from .serve import ServeConfig, ServingEngine, SparseGemmBatcher

# the reference's submodules reachable as repro_torch.<name>
_MODULES = ("configs", "core", "hwmodel", "hybrid", "kernels", "models",
            "obs", "plan", "sccp", "serve")

__all__ = [
    *_MODULES, "AccumulatorOverflow", "Coo", "DistPlan", "EllCols",
    "EllRows", "Model", "NmWeights", "Plan", "ServeConfig", "ServingEngine", "SparseGemmBatcher",
    "SparseLinear", "SparseMLP", "SpgemmStructure", "StructureCache",
    "build_model", "check_no_overflow", "checkpoint", "coo_from_dense",
    "count_products", "data", "launch", "optim", "runtime",
    "default_device", "detect_nm", "ell_cols_from_dense",
    "ell_rows_from_dense", "fingerprint", "from_numpy", "magnitude_prune",
    "magnitude_prune_nm", "make_dist_plan", "make_plan", "make_structure",
    "make_structure_batched", "moe_apply", "nm_from_dense", "nm_from_numpy",
    "nm_spmm", "np_ell_cols_from_scipy", "np_ell_rows_from_scipy",
    "parallel", "params_from_numpy", "plan_spmm_format", "spgemm", "spgemm_dense",
    "to_numpy",
]
