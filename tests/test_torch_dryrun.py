"""repro_torch's dry run against the JAX reference on the CPU: the
logical-axis rules, the production meshes, the abstract argument trees of
every step and their layouts, the op count and the ``launch.dryrun``
entry point.

The reference lays its trees out on ``jax.sharding.AbstractMesh`` (no
devices) and gives each leaf's block by ``NamedSharding.shard_shape``; the
port's leaves are ``meta`` tensors carrying a ``NamedSharding`` of their
own. Every leaf's spec, block shape and dtype, and the per-device argument
bytes, must be equal, for every config, each of its applicable shapes and
both production meshes, at published widths. ``prefill_out_shardings`` is
held on both meshes for every config on a 512-token prefill at the cells'
global batch of 32 (a whole number of both scans' chunks): the port runs
the prefill on meta to read its outputs, which at 32,768 tokens takes
minutes for the scans.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax
from jax.sharding import AbstractMesh, NamedSharding as RNamedSharding

from repro.configs import ARCHS as RARCHS
from repro.configs import applicable_shapes as rapplicable
from repro.configs.base import ShapeCase as RCase
from repro.launch import steps as rsteps
from repro.models import build_model as rbuild
from repro.parallel import sharding as rsh
from repro_torch.configs import ARCHS, applicable_shapes, get_config
from repro_torch.configs.base import ShapeCase
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import analyze
from repro_torch.models import build_model
from repro_torch.models.params import (abstract_params, param_shardings,
                                       tree_items)
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import make_mesh
from repro_torch.parallel import sharding as tsh

REPO = Path(__file__).resolve().parents[1]
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PREFILL_SHORT = 512


def meshes(name):
    shape, axes = MESHES[name]
    return (AbstractMesh(shape, axes),
            make_production_mesh(multi_pod=name == "pod2x16x16"))


def small_mesh(shape, axes):
    return make_mesh(shape, axes, ["meta"] * math.prod(shape))


# ---------------------------------------------------------------------------
# (1) the rules
# ---------------------------------------------------------------------------

RULE_CASES = [
    # yi-34b's 56 heads do not divide 16: replicated
    ("pod16x16", None, ("batch", None, "heads", None), (256, 4096, 56, 128)),
    # "heads" takes "model"; "ff" finds it used
    ("pod16x16", None, ("heads", "ff"), (64, 128)),
    # "batch" maps to ("pod", "data"): "pod" is not on (16, 16)
    ("pod16x16", None, ("batch", None), (256, 4096)),
    ("pod2x16x16", None, ("batch", None), (256, 4096)),
    # batch 16 on (2, 16, 16): "pod" then 2·16 does not divide, "data" drops
    ("pod2x16x16", None, ("batch", "vocab"), (16, 49155)),
    # a three-axis batch on (2, 16, 16): all three, then all but "model"
    ("pod2x16x16", {"batch": ("pod", "data", "model")}, ("batch",), (512,)),
    ("pod2x16x16", {"batch": ("pod", "data", "model")}, ("batch", "ff"),
     (32, 4096)),
    # an unknown logical name and a scalar
    ("pod16x16", None, ("nonesuch", "expert"), (16, 64)),
    ("pod16x16", None, (), ()),
]


@pytest.mark.parametrize("mesh_name,rules,axes,shape", RULE_CASES)
def test_resolve_matches_reference(mesh_name, rules, axes, shape):
    rmesh, tmesh = meshes(mesh_name)
    with rsh.sharding_rules(rmesh, rules) as rr, \
            tsh.sharding_rules(tmesh, rules) as tr:
        want = rr.resolve(axes, shape)
        assert tr.resolve(axes, shape) == tuple(want)
        assert tsh.logical_to_pspec(axes, shape) == tuple(
            rsh.logical_to_pspec(axes, shape))
        got = tsh.named_sharding(axes, shape)
        ref = RNamedSharding(rmesh, want)
        assert got.shard_shape(shape) == tuple(ref.shard_shape(shape))
        for name in ("batch", "heads", "opt_shard", "nonesuch"):
            assert tsh.axis_size(name) == rsh.axis_size(name)


LOGICAL = [None, *tsh.DEFAULT_RULES]
MESH_CHOICES = [((16, 16), ("data", "model")),
                ((2, 16, 16), ("pod", "data", "model")),
                ((2, 4), ("data", "model")), ((3, 2), ("model", "data")),
                ((4,), ("data",))]


@settings(max_examples=150, deadline=None)
@given(mesh_i=st.integers(0, len(MESH_CHOICES) - 1),
       dims=st.lists(st.tuples(st.sampled_from(LOGICAL),
                               st.sampled_from([1, 2, 3, 6, 8, 16, 24, 32,
                                                56, 64, 512, 49155])),
                     max_size=4))
def test_resolve_matches_reference_drawn(mesh_i, dims):
    shape, names = MESH_CHOICES[mesh_i]
    axes = tuple(a for a, _ in dims)
    dims_ = tuple(d for _, d in dims)
    with rsh.sharding_rules(AbstractMesh(shape, names)) as rr, \
            tsh.sharding_rules(small_mesh(shape, names)) as tr:
        want = rr.resolve(axes, dims_)
        got = tr.resolve(axes, dims_)
        assert got == tuple(want)
        assert tsh.shard_shape(got, dims_, tr.mesh) == tuple(
            RNamedSharding(rr.mesh, want).shard_shape(dims_))


def test_rules_without_a_mesh_and_wrong_rank():
    x = torch.empty((4, 8), device="meta")
    assert tsh.current_rules() is None
    assert tsh.logical_to_pspec(("batch", "ff"), (4, 8)) == ()
    assert tsh.named_sharding(("batch", "ff"), (4, 8)) is None
    assert tsh.axis_size("batch") == 1
    assert tsh.maybe_shard(x, "batch", "ff") is x
    with tsh.sharding_rules(None) as r:
        assert r.resolve(("batch", "ff"), (4, 8)) == (None, None)
    with tsh.sharding_rules(make_production_mesh()):
        assert tsh.maybe_shard(x, "batch", "ff") is x
        with pytest.raises(ValueError):
            tsh.maybe_shard(x, "batch")
        spec = tadamw.Spec((4, 8), ("heads", None))
        rules = tsh.current_rules()
        assert rules.resolve(tadamw._moment_axes(spec), x.shape) == (
            None, None)
        with pytest.raises(ValueError):
            rules.resolve(tadamw._moment_axes(spec), (4,))
        with pytest.raises(ValueError):
            tsh.shard_shape(("model",), (56,), make_production_mesh())
    assert tsh.current_rules() is None


def test_production_meshes():
    for name, (shape, axes) in MESHES.items():
        m = make_production_mesh(multi_pod=name == "pod2x16x16")
        assert m.shape == dict(zip(axes, shape))
        assert m.size == math.prod(shape)
        assert {d.type for d in m.devices.reshape(-1)} == {"meta"}


# ---------------------------------------------------------------------------
# (2) every config's abstract arguments on both production meshes
# ---------------------------------------------------------------------------

def _key(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def ref_leaves(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        sh = leaf.sharding
        out.append((_key(path), tuple(leaf.shape), str(leaf.dtype),
                    tuple(sh.spec), tuple(sh.shard_shape(leaf.shape))))
    return out


def port_leaves(tree):
    out = []
    for key, t in tree_items(tree, sort=True):
        sh = t.sharding
        out.append((key, tuple(t.shape), str(t.dtype).split(".")[-1],
                    sh.spec, sh.shard_shape(t.shape)))
    return out


def leaf_bytes(leaves) -> int:
    return sum(math.prod(block) * np.dtype(
        jax.numpy.dtype(dtype)).itemsize for _, _, dtype, _, block in leaves)


REF_ARGS = {"train": rsteps.abstract_train_args,
            "prefill": rsteps.abstract_prefill_args,
            "decode": rsteps.abstract_decode_args}
PORT_ARGS = {"train": steps.abstract_train_args,
             "prefill": steps.abstract_prefill_args,
             "decode": steps.abstract_decode_args}


def ref_argument_bytes(arch: str, shape: str, mesh_name: str) -> int:
    rmesh, _ = meshes(mesh_name)
    case = next(c for c in rapplicable(RARCHS[arch]) if c.name == shape)
    with rsh.sharding_rules(rmesh):
        return leaf_bytes(ref_leaves(REF_ARGS[case.kind](
            rbuild(RARCHS[arch]), case)))


@pytest.mark.parametrize("arch", list(RARCHS))
def test_abstract_args_match_reference(arch):
    """Every leaf's path, shape, dtype, spec and block, and the argument
    bytes a device, for each applicable shape on both meshes."""
    assert [c.name for c in applicable_shapes(ARCHS[arch])] == \
        [c.name for c in rapplicable(RARCHS[arch])]
    rm, tm = rbuild(RARCHS[arch]), build_model(ARCHS[arch])
    for mesh_name in MESHES:
        rmesh, tmesh = meshes(mesh_name)
        for case in applicable_shapes(ARCHS[arch]):
            rcase = RCase(case.name, case.seq_len, case.global_batch,
                          case.kind)
            with rsh.sharding_rules(rmesh):
                ref = ref_leaves(REF_ARGS[case.kind](rm, rcase))
            with tsh.sharding_rules(tmesh):
                args = PORT_ARGS[case.kind](tm, case)
            got = port_leaves(args)
            assert len(got) == len(ref), (mesh_name, case.name)
            for g, r in zip(got, ref):
                assert g == r, (mesh_name, case.name)
            assert dryrun.device_bytes(args) == leaf_bytes(ref), \
                (mesh_name, case.name)
            assert {t.device.type for _, t in tree_items(args)} == {"meta"}


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "whisper-medium"])
def test_param_shardings_match_reference(arch):
    from repro.models.params import param_shardings as rparam_shardings
    rm, tm = rbuild(RARCHS[arch]), build_model(ARCHS[arch])
    for mesh_name in MESHES:
        rmesh, tmesh = meshes(mesh_name)
        with rsh.sharding_rules(rmesh):
            want = [(_key(p), tuple(s.spec)) for p, s in
                    jax.tree_util.tree_flatten_with_path(
                        rparam_shardings(rm.specs()))[0]]
        with tsh.sharding_rules(tmesh):
            got = [(k, s.spec) for k, s in
                   tree_items(param_shardings(tm.specs()), sort=True)]
            meta = abstract_params(tm.specs())
            assert [t.sharding for _, t in tree_items(meta, sort=True)] == \
                [s for _, s in tree_items(param_shardings(tm.specs()),
                                          sort=True)]
        assert got == want
    assert all(t.sharding is None
               for _, t in tree_items(tm.abstract_params()))
    with pytest.raises(RuntimeError):
        param_shardings(tm.specs())


@pytest.mark.parametrize("arch", list(RARCHS))
def test_prefill_out_shardings_match_reference(arch):
    rm, tm = rbuild(RARCHS[arch]), build_model(ARCHS[arch])
    case = ShapeCase("prefill_short", PREFILL_SHORT, 32, "prefill")
    rcase = RCase(case.name, case.seq_len, case.global_batch, case.kind)
    tstep = steps.make_prefill_step(tm, s_max=case.seq_len)
    with tsh.sharding_rules(make_production_mesh()):
        out = tstep(*steps.abstract_prefill_args(tm, case))
    for mesh_name in MESHES:
        rmesh, tmesh = meshes(mesh_name)
        with rsh.sharding_rules(rmesh):
            r_logits, r_cache = rsteps.prefill_out_shardings(
                rm, rcase, rsteps.make_prefill_step(rm, case.seq_len))
        with tsh.sharding_rules(tmesh):
            t_logits, t_cache = steps.prefill_out_shardings(tm, case, tstep,
                                                            out)
        assert t_logits.spec == tuple(r_logits.spec)
        want = [(_key(p), tuple(s.spec)) for p, s in
                jax.tree_util.tree_flatten_with_path(r_cache)[0]]
        assert [(k, s.spec) for k, s in tree_items(t_cache, sort=True)] \
            == want


def test_prefill_out_shardings_runs_the_step():
    tm = build_model(ARCHS["qwen2-0.5b"])
    case = ShapeCase("prefill_short", PREFILL_SHORT, 32, "prefill")
    step = steps.make_prefill_step(tm, s_max=case.seq_len)
    with tsh.sharding_rules(make_production_mesh()):
        logits_sh, cache_sh = steps.prefill_out_shardings(tm, case, step)
        assert logits_sh.spec == ("data", None)
        assert cache_sh["pos"].spec == ()
    with pytest.raises(RuntimeError):
        steps.prefill_out_shardings(tm, case, step)


# ---------------------------------------------------------------------------
# (3) the op count
# ---------------------------------------------------------------------------

def test_op_analysis_counts_a_loop():
    """tests/test_hlo_analysis.py's sample: five 8 x 8 matmuls in a loop,
    2·8·8·8 FLOPs each, no collectives to count."""
    def body(x):
        for _ in range(5):
            x = x @ x
        return x

    for dev in ("meta", "cpu"):
        out, cost = analyze(body, torch.ones((8, 8), device=dev))
        assert cost["flops"] == 5 * 1024
        assert cost["hbm_bytes"] == 5 * 3 * 256   # two operands and out
        # the argument, the current and the next product
        assert cost["peak_live_bytes"] == 3 * 256
        assert cost["n_ops"] == 5
        assert cost["collective_bytes"] is None
        assert "collective_trace" in cost["gaps"]["collective_bytes"]
        assert out.shape == (8, 8)


def test_op_analysis_live_bytes_follow_lifetimes():
    def body(x):
        y = x.exp()                 # 4 KiB, freed before z
        del y
        z = x.exp()
        v = z.view(32, 32)          # a view: no new storage, no bytes
        w = v.t().contiguous()      # a copy: 4 KiB more
        return z, w

    x = torch.empty(1024, device="meta")
    _, cost = analyze(body, x)
    assert cost["peak_live_bytes"] == 3 * 4096
    assert cost["hbm_bytes"] == 3 * 2 * 4096

    # tensors saved for the backward stay live until it frees them
    a = torch.empty(1024, device="meta", requires_grad=True)

    def grad_of(a):
        c = a.exp().exp().sum()
        return torch.autograd.grad(c, a)[0]

    _, cost = analyze(grad_of, a)
    assert cost["peak_live_bytes"] >= 3 * 4096


def test_op_analysis_meta_equals_a_real_run():
    """The same train step on real CPU tensors and on meta ones counts the
    same FLOPs and bytes (``chip_smoke.py``'s gate (b) on the card), and
    live bytes within 25% (its gate (c))."""
    cfg = get_config("qwen2-0.5b-smoke")
    model = build_model(cfg)
    case = ShapeCase("t", 32, 2, "train")
    with tsh.sharding_rules(small_mesh((1, 1), ("data", "model"))):
        meta_args = steps.abstract_train_args(model, case)
    _, meta = analyze(steps.make_train_step(model, tadamw.AdamWConfig()),
                      *meta_args)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt = tadamw.adamw_init(params)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32),
                                     dtype=torch.int32)}
    _, real = analyze(steps.make_train_step(model, tadamw.AdamWConfig()),
                      params, opt, batch)
    assert meta["flops"] == real["flops"] > 0
    assert meta["hbm_bytes"] == real["hbm_bytes"]
    assert dryrun.device_bytes(meta_args) == sum(
        t.numel() * t.element_size() for _, t in tree_items(
            (params, opt, batch)))
    assert abs(meta["peak_live_bytes"] - real["peak_live_bytes"]) <= \
        0.25 * real["peak_live_bytes"]


# ---------------------------------------------------------------------------
# (4) the reference's consistency check on a dense train cell
# ---------------------------------------------------------------------------

def test_dense_train_flops_near_6nd():
    """qwen2-0.5b at train_4k on (16, 16): 6·N·D a device below the count
    and the count below three times it (recompute, attention)."""
    rec = dryrun.analyze_cell(get_config("qwen2-0.5b"),
                              next(c for c in applicable_shapes(
                                  ARCHS["qwen2-0.5b"])
                                   if c.name == "train_4k"),
                              make_production_mesh())
    model_flops = 6 * rec["n_params"] * 256 * 4096 / rec["n_devices"]
    assert model_flops < rec["flops_per_device"] < 3 * model_flops
    assert rec["flops_per_device"] == rec["flops"] / 256
    assert rec["peak_live_bytes"] > rec["mem_per_device"]["argument_bytes"]
    # the step updates params and state in place: its outputs are its
    # arguments without the batch, and three float32 metrics
    batch = 256 * 4096 * 4 // 16
    assert rec["mem_per_device"]["output_bytes"] == \
        rec["mem_per_device"]["argument_bytes"] - batch + 3 * 4
    # the partitioned step's collectives: the forward's, the backward's
    # duals and the ZeRO-1 update's
    assert rec["collective_count"]["reduce-scatter"] > 0
    assert rec["collective_count"]["all-reduce"] > 0
    assert set(rec["gaps"]) == {"temp_bytes"}


def test_collectives_filled_for_decoder_serving_cells():
    """qwen2-0.5b's prefill (32 x 512) and decode (128 at 512) cells count
    the partitioned program's collectives on both production meshes: per
    layer a reduce-scatter after ``wo`` and after the FFN in prefill (the
    sequence splits 16 ways), plus the embedding's; in decode an
    all-reduce for each and for the flash merge (14 heads do not split 16
    ways). A train cell of a decoder counts its step's collectives (none
    on a mesh of one device). An SSM decode cell on (1, 4) counts, per
    layer, the in-projection's all-gather and the all-reduces of ``w_x``'s
    and ``w_out``'s partial sums, plus the vocab's all-reduce and
    all-gather."""
    cfg = get_config("qwen2-0.5b")
    kinds = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute"}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for case, key, n in ((ShapeCase("p", 512, 32, "prefill"),
                              "reduce-scatter", 2 * 24 + 1),
                             (ShapeCase("d", 512, 128, "decode"),
                              "all-reduce", 3 * 24 + 1)):
            rec = dryrun.analyze_cell(cfg, case, mesh)
            assert set(rec["collective_bytes"]) == kinds
            assert rec["collective_count"][key] == n, (case.kind, multi_pod)
            assert rec["collective_bytes"]["all-gather"] > 0
            assert "collective_bytes" not in rec["gaps"]
    small = small_mesh((1, 1), ("data", "model"))
    rec = dryrun.analyze_cell(get_config("qwen2-0.5b-smoke"),
                              ShapeCase("t", 32, 4, "train"), small)
    assert set(rec["collective_count"]) == kinds
    assert not any(rec["collective_count"].values())
    assert "collective_bytes" not in rec["gaps"]
    cfg = get_config("falcon-mamba-7b-smoke")
    rec = dryrun.analyze_cell(cfg, ShapeCase("d", 32, 2, "decode"),
                              small_mesh((1, 4), ("data", "model")))
    assert set(rec["collective_bytes"]) == kinds
    assert rec["collective_count"] == {
        "all-gather": cfg.n_layers + 1, "all-reduce": 2 * cfg.n_layers + 1,
        "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
    assert "collective_bytes" not in rec["gaps"]


# ---------------------------------------------------------------------------
# (5) the entry point in a fresh process
# ---------------------------------------------------------------------------

def test_dryrun_entrypoint_single_cell(tmp_path):
    """The cheapest cell, falcon-mamba long_500k (decode, batch 1), through
    ``python -m repro_torch.launch.dryrun``, its collectives counted: the
    64 layers' in-projection gathers and partial-sum reduces."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "falcon-mamba-7b", "--shape", "long_500k", "--single-pod-only",
         "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((tmp_path / "falcon-mamba-7b__long_500k__pod16x16.json")
                     .read_text())
    assert rec["n_devices"] == 256
    assert rec["flops"] > 0
    assert rec["mem_per_device"]["argument_bytes"] == ref_argument_bytes(
        "falcon-mamba-7b", "long_500k", "pod16x16")
    assert rec["collective_count"]["all-gather"] >= 64
    assert rec["collective_count"]["all-reduce"] >= 2 * 64
    assert rec["collective_bytes"]["all-reduce"] > 0
    assert set(rec["gaps"]) == {"temp_bytes"}


def test_dryrun_records_failures(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "nonesuch",
                     "--single-pod-only", "--out", str(tmp_path)])
    assert e.value.code == 1
    assert "1 FAILURES" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-0.5b"])
    assert e.value.code == 2
    assert list(dryrun.iter_cells()) == [
        (n, c.name) for n, cfg in RARCHS.items() for c in rapplicable(cfg)]


def test_spmm_dispatch_traces_on_meta():
    """K9's wrapper takes its plain twin on meta tensors, so the 'spmm'
    dispatch's train step traces as the 'sort' one does."""
    import dataclasses
    base = get_config("granite-moe-3b-a800m-smoke")
    case = ShapeCase("t", 32, 4, "train")
    mesh = small_mesh((1, 1), ("data", "model"))
    recs = {d: dryrun.analyze_cell(dataclasses.replace(
        base, moe=dataclasses.replace(base.moe, dispatch=d)), case, mesh)
        for d in ("sort", "spmm")}
    assert recs["spmm"]["flops"] > 0
    assert recs["spmm"]["mem_per_device"] == recs["sort"]["mem_per_device"]


def test_dryrun_skip_done_with_dispatch(tmp_path, capsys):
    """``--skip-done`` finds the record ``run_cell`` wrote under the same
    ``--dispatch``, and traces nothing again."""
    rec = dryrun.run_cell("granite-moe-3b-a800m", "decode_32k", False,
                          tmp_path, dispatch="sort")
    name = "granite-moe-3b-a800m__decode_32k__pod16x16__sort.json"
    assert json.loads((tmp_path / name).read_text()) == rec
    assert rec["dispatch"] == "sort"
    capsys.readouterr()
    dryrun.main(["--arch", "granite-moe-3b-a800m", "--shape", "decode_32k",
                 "--single-pod-only", "--dispatch", "sort", "--skip-done",
                 "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"[skip] {name}" in out and "[OK]" not in out
