"""repro_torch's LM under a mesh against the reference's own sharded
program on the CPU.

The reference runs in subprocesses with 8 fake CPU devices
(``conftest.run_with_devices``), each mesh built with Auto axes (jax 0.9's
``make_mesh`` defaults to Explicit ones, which the reference's
``with_sharding_constraint`` calls refuse): ``jax.value_and_grad`` of its
loss, one AdamW train step and a ``generate_batch`` wave, each under
``sharding_rules(mesh)``. The port runs the same weights (the reference's
``Model.init``, carried over by ``params_from_numpy``) and tokens on
``launch.mesh.make_host_mesh(m, devices=["cpu"] * 8)``.

A mesh changes the numbers in three places, which these cases reach: the
MoE layer's tokens form one group a data shard (capacity, and so the
dropped pairs, a group), ``'sort'`` runs its region shard by shard (expert
or hidden-dim slices, expert offsets, one ``psum`` over ``"model"``), and
its aux loss is the mean of the data shards' own. Cases: the reduced
granite-moe-3b-a800m and deepseek-v2-lite-16b (shared experts, MLA) under
each dispatch on (1, 8), (2, 4), (4, 2) and (8, 1) — at (8, 1) the batch
of 4 does not divide the data axis and the groups replicate — and
granite's ``'sort'`` with 6 experts (only the hidden dim splits, on (2, 4)
and (1, 8)) and with 6 experts of width 30 (nothing splits). The loss is
held within 1e-5 relative and every gradient leaf within 1e-5 of its max.
"""
import concurrent.futures
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from conftest import run_with_devices
from repro import configs as rcfg
from repro.models import build_model as rbuild
from repro_torch import configs as tcfg
from repro_torch.core.formats import params_from_numpy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model as tbuild
from repro_torch.models.params import sorted_leaves
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import mesh as pmesh
from repro_torch.parallel import sharding_rules
from repro_torch.serve import ServeConfig, ServingEngine

RTOL = 1e-5
ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
MESHES = ((1, 8), (2, 4), (4, 2), (8, 1))
DISPATCHES = ("sort", "ellpack", "spmm")
SPLITS = {"hidden": dict(n_experts=6), "none": dict(n_experts=6,
                                                    d_ff_expert=30)}
SERVE = dict(max_batch=4, max_new_tokens=6, s_max=32)
BATCH = (4, 16)


def _case(arch, dispatch, mesh, split=None):
    return f"{arch}|{dispatch}|{mesh[0]}x{mesh[1]}|{split or ''}"


LOSS_CASES = ([(a, d, m, None) for a in ARCHS for d in DISPATCHES
               for m in MESHES]
              + [("granite-moe-3b-a800m", "sort", (2, 4), "hidden"),
                 ("granite-moe-3b-a800m", "sort", (1, 8), "hidden"),
                 ("granite-moe-3b-a800m", "sort", (2, 4), "none")])

# The reference's side: a job list in, one .npz out.
REF = r'''
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch.steps import make_train_step
from repro.models import build_model
from repro.optim import AdamWConfig, adamw_init
from repro.parallel.sharding import sharding_rules
from repro.serve import ServeConfig, ServingEngine
jobs, out_path = json.loads(sys.argv[1]), sys.argv[2]
out = {}

def config(arch, dispatch, over):
    cfg = get_config(arch).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch=dispatch, **over))

def mesh_of(shape):
    return jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

for job in jobs:
    cfg = config(job["arch"], job["dispatch"], job["over"])
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(1))
    key = job["key"]
    out[key + "/wsum"] = np.float64(sum(
        np.abs(np.asarray(x, np.float64)).sum()
        for x in jax.tree.leaves(params)))
    tokens = jnp.asarray(np.asarray(job["tokens"], np.int32))
    mesh = mesh_of(job["mesh"])
    with sharding_rules(mesh), mesh:
        if job["kind"] == "loss":
            loss, g = jax.jit(jax.value_and_grad(model.loss))(
                params, {"tokens": tokens})
            out[key + "/loss"] = np.asarray(loss)
            for i, x in enumerate(jax.tree.leaves(g)):
                out[f"{key}/g{i}"] = np.asarray(x)
        elif job["kind"] == "train":
            step = jax.jit(make_train_step(model, AdamWConfig()))
            p2, o2, m = step(params, adamw_init(params), {"tokens": tokens})
            for name in ("loss", "grad_norm"):
                out[f"{key}/{name}"] = np.asarray(m[name])
            for i, x in enumerate(jax.tree.leaves(p2)):
                out[f"{key}/p{i}"] = np.asarray(x)
            for i, x in enumerate(jax.tree.leaves(o2["mu"])):
                out[f"{key}/mu{i}"] = np.asarray(x)
        else:
            eng = ServingEngine(model, params, ServeConfig(**job["serve"]))
            got = eng.generate_batch([np.asarray(p, np.int32)
                                      for p in job["prompts"]])
            out[key + "/tokens"] = np.asarray(json.dumps(got))
np.savez(out_path, **out)
print("OK")
'''


def _over(split):
    return SPLITS[split] if split else {}


def _tokens(vocab):
    return np.random.default_rng(2).integers(0, vocab, BATCH).astype(np.int32)


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(3, vocab, int(n)).astype(np.int32)
            for n in (5, 11, 8, 14)]


def _loss_job(arch, dispatch, mesh, split):
    return {"kind": "loss", "key": _case(arch, dispatch, mesh, split),
            "arch": arch, "dispatch": dispatch, "over": _over(split),
            "mesh": mesh, "tokens": _tokens(256).tolist()}


TRAIN_KEY = "train|granite-moe-3b-a800m|sort|4x2"
SERVE_KEY = "serve|deepseek-v2-lite-16b|sort|2x4"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results for every case, from two subprocesses of 8
    fake devices run side by side (granite's cases and the train step in
    one, deepseek's and the serving wave in the other)."""
    tmp = tmp_path_factory.mktemp("ref_mesh")
    jobs = {a: [_loss_job(*c) for c in LOSS_CASES if c[0] == a]
            for a in ARCHS}
    jobs[ARCHS[0]].append({
        "kind": "train", "key": TRAIN_KEY, "arch": ARCHS[0],
        "dispatch": "sort", "over": {}, "mesh": (4, 2),
        "tokens": _tokens(256).tolist()})
    jobs[ARCHS[1]].append({
        "kind": "serve", "key": SERVE_KEY, "arch": ARCHS[1],
        "dispatch": "sort", "over": {}, "mesh": (2, 4), "tokens": [],
        "serve": SERVE, "prompts": [p.tolist() for p in _prompts(256)]})

    def run(arch):
        path = tmp / f"{arch}.npz"
        argv = ["ref", json.dumps(jobs[arch]), str(path)]
        run_with_devices(f"import sys\nsys.argv = {argv!r}\n" + REF, 8,
                         timeout=600)
        return dict(np.load(path))

    with concurrent.futures.ThreadPoolExecutor(len(ARCHS)) as pool:
        parts = list(pool.map(run, ARCHS))
    return {k: v for part in parts for k, v in part.items()}


def _port(arch, dispatch, split=None):
    """(the port's model, the reference's weights as numpy)."""
    over = _over(split)
    rc = rcfg.get_config(arch).reduced()
    rc = dataclasses.replace(rc, moe=dataclasses.replace(
        rc.moe, dispatch=dispatch, **over))
    tc = tcfg.get_config(arch).reduced()
    tc = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, dispatch=dispatch, **over))
    weights = jax.tree.map(np.asarray, rbuild(rc).init(jax.random.PRNGKey(1)))
    return tbuild(tc), weights


def _mesh(shape):
    return make_host_mesh(shape[1], devices=["cpu"] * (shape[0] * shape[1]))


def _close(got, want, what):
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got.detach().numpy() - want).max())
    scale = float(np.abs(want).max())
    assert err <= RTOL * scale, (what, err, scale)


@pytest.mark.parametrize("arch,dispatch,mesh,split", LOSS_CASES,
                         ids=[_case(*c) for c in LOSS_CASES])
def test_loss_and_grads_match_sharded_reference(ref, arch, dispatch, mesh,
                                                split):
    """``Model.loss`` and every gradient leaf on the port's CPU mesh
    against ``jax.value_and_grad`` of the reference under the same mesh."""
    key = _case(arch, dispatch, mesh, split)
    model, weights = _port(arch, dispatch, split)
    tp = params_from_numpy(weights, device="cpu")
    assert float(sum(np.abs(w.astype(np.float64)).sum()
                     for w in jax.tree.leaves(weights))) \
        == float(ref[key + "/wsum"])
    leaves = sorted_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    with sharding_rules(_mesh(mesh)):
        loss = model.loss(tp, {"tokens": torch.from_numpy(_tokens(256))})
        grads = torch.autograd.grad(loss, leaves)
    want = float(ref[key + "/loss"])
    assert abs(loss.item() - want) <= RTOL * abs(want), (loss.item(), want)
    n = sum(1 for k in ref if k.startswith(key + "/g"))
    assert n == len(grads)
    for i, g in enumerate(grads):
        _close(g, ref[f"{key}/g{i}"], i)


def test_sort_aux_pmean_differs_from_grouped_aux(ref):
    """At (2, 4) ``'sort'`` and ``'ellpack'`` take the same two groups
    but their aux losses differ (a mean of each data shard's own against
    one over both groups): the reference's losses differ, and so do the
    port's, each by the same amount."""
    a, b = (_case("granite-moe-3b-a800m", d, (2, 4)) for d in ("sort",
                                                              "ellpack"))
    gap = float(ref[a + "/loss"]) - float(ref[b + "/loss"])
    assert abs(gap) > 1e-4
    got = []
    for dispatch in ("sort", "ellpack"):
        model, weights = _port("granite-moe-3b-a800m", dispatch)
        with sharding_rules(_mesh((2, 4))), torch.no_grad():
            got.append(model.loss(params_from_numpy(weights, device="cpu"),
                                  {"tokens": torch.from_numpy(
                                      _tokens(256))}).item())
    assert abs((got[0] - got[1]) - gap) <= 1e-5 * abs(got[0])


def test_train_step_matches_sharded_reference(ref):
    """One AdamW step (``launch.steps.make_train_step``) on (4, 2): the
    loss and grad norm within 1e-5 relative, the first moments within 1e-5
    of their max, and each parameter within 1e-6 of the reference's where
    its gradient's sign is well determined (|g| above 1e-3 of the leaf's
    max; a first Adam step moves a weight by ±lr·g/|g|), within two steps'
    size elsewhere."""
    model, weights = _port("granite-moe-3b-a800m", "sort")
    tp = params_from_numpy(weights, device="cpu")
    cfg = AdamWConfig()
    with sharding_rules(_mesh((4, 2))):
        p2, o2, m = make_train_step(model, cfg)(
            tp, adamw_init(tp), {"tokens": torch.from_numpy(_tokens(256))})
    for name in ("loss", "grad_norm"):
        want = float(ref[f"{TRAIN_KEY}/{name}"])
        assert abs(m[name].item() - want) <= RTOL * abs(want), name
    lr1 = cfg.lr / max(1, cfg.warmup_steps)
    mus = sorted_leaves(o2["mu"])
    for i, (p, mu) in enumerate(zip(sorted_leaves(p2), mus)):
        want_mu = ref[f"{TRAIN_KEY}/mu{i}"]
        _close(mu, want_mu, ("mu", i))
        err = np.abs(p.detach().numpy() - ref[f"{TRAIN_KEY}/p{i}"])
        sure = np.abs(want_mu) > 1e-3 * np.abs(want_mu).max()
        assert float(err[sure].max(initial=0)) <= 1e-6, ("p", i)
        assert float(err.max()) <= 2 * lr1 + 1e-6, ("p", i)


def test_generate_batch_matches_sharded_reference(ref):
    """A wave of four prompts through ``ServingEngine.generate_batch`` on
    (2, 4): the prefill's and each decode step's MoE layers split the wave
    into two groups. Greedy tokens equal the reference's one for one."""
    model, weights = _port("deepseek-v2-lite-16b", "sort")
    eng = ServingEngine(model, params_from_numpy(weights, device="cpu"),
                        ServeConfig(**SERVE))
    with sharding_rules(_mesh((2, 4))):
        got = eng.generate_batch(_prompts(256))
    assert got == json.loads(str(ref[SERVE_KEY + "/tokens"]))


def test_sort_region_views_and_moved_bytes():
    """On a CPU mesh every block of the ``'sort'`` region lies on its own
    device, so it is taken as a view: ``moved_bytes`` counts only the
    ``psum`` of the partial combines (each data shard's ``(G_loc, Tg, d)``
    output from each ``"model"`` shard past the first)."""
    model, weights = _port("granite-moe-3b-a800m", "sort")
    tp = params_from_numpy(weights, device="cpu")
    pmesh.reset_moved_bytes()
    with sharding_rules(_mesh((2, 4))), torch.no_grad():
        model.loss(tp, {"tokens": torch.from_numpy(_tokens(256))})
    cfg = model.cfg
    layers = cfg.n_layers - cfg.moe.first_dense_layers
    per_shard = BATCH[0] * BATCH[1] // 2 * cfg.d_model * 4
    assert pmesh.moved_bytes() == layers * 2 * 3 * per_shard


def test_remat_recompute_keeps_the_mesh_on_another_thread():
    """Autograd runs a card's backward on a thread of its own, where the
    thread-local sharding rules are unset; each block's checkpoint
    (``remat="full"``) must recompute under the rules of its forward.
    The backward run from another thread gives the grads of one run on
    this thread, bit for bit."""
    import threading
    model, weights = _port("granite-moe-3b-a800m", "sort")
    assert model.cfg.remat == "full"
    batch = {"tokens": torch.from_numpy(_tokens(256))}
    grads = []
    for on_thread in (False, True):
        tp = params_from_numpy(weights, device="cpu")
        leaves = sorted_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        with sharding_rules(_mesh((2, 4))):
            loss = model.loss(tp, batch)
        out = []
        run = (lambda: out.append(torch.autograd.grad(loss, leaves)))
        if on_thread:
            t = threading.Thread(target=run)
            t.start()
            t.join()
        else:
            with sharding_rules(_mesh((2, 4))):
                run()
        assert len(out) == 1
        grads.append(out[0])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
