"""repro_torch's partitioned training step against the reference's own
sharded train step on the CPU.

Under ``sharding_rules(mesh)`` with the weights placed (``Model.place``)
one step of ``launch.steps.make_train_step`` runs partitioned: the loss on
each coordinate's blocks, the backward through every collective's dual
(``parallel.mesh``), each placed leaf's gradient laid out like the leaf
(``parallel.sharding.leaf_grads``) and the ZeRO-1 AdamW update on moments
laid out by ``opt_state_specs`` (``optim.adamw``). The reference runs in
one subprocess with 8 fake CPU devices (``conftest.run_with_devices``,
Auto axes, most XLA optimizations off, as ``tests/test_torch_lm_mesh.py``
builds them): ``jax.jit`` of its train step's body (``value_and_grad`` of
``Model.loss``, then ``adamw_update`` with ``param_specs``), its
arguments put on the mesh by the dry run's shardings
(``abstract_train_args``: ``param_shardings`` and ``opt_state_specs``).
The port draws the weights and hands them over; it runs on
``make_host_mesh(m, ["cpu"] * 8)``.

Reference cases: the reduced granite-moe-3b-a800m with ``'sort'`` and
``'spmm'`` on (2, 4) and (1, 8) (8 experts: split on ``"model"``), the
reduced deepseek-v2-lite-16b (MLA, shared experts, a dense first layer)
on (2, 4), and qwen2-0.5b (tied vocab, a ``qkv_flat`` split inside a
head) with a vocab of 255, which no ``"model"`` axis divides, on (2, 4).
Port-only cases run on ``["cpu"] * 4``.
"""
import concurrent.futures
import dataclasses
import functools
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_with_devices
from repro_torch import configs as tcfg
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model as tbuild
from repro_torch.models.params import (sorted_leaves, tree_items, tree_leaves,
                                       tree_map, tree_unflatten)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import make_mesh, sharding_rules
from repro_torch.parallel import mesh as pmesh
from repro_torch.parallel.sharding import (Sharded, grad_leaves, leaf_grads,
                                           mesh_coords, reduce)

RTOL = 1e-5              # the loss, relative; the moments, of their max
GTOL = 2e-5              # each gradient leaf, of its max
WTOL = 2e-6              # placed against whole weights on the port alone:
                         # the float32 sums' order differs (up to 1.0e-6
                         # of max seen, on internvl2's tied table)
BATCH = (4, 16)
CASES = [("granite-moe-3b-a800m", "sort", (2, 4), None),
         ("granite-moe-3b-a800m", "sort", (1, 8), None),
         ("granite-moe-3b-a800m", "spmm", (2, 4), None),
         ("granite-moe-3b-a800m", "spmm", (1, 8), None),
         ("deepseek-v2-lite-16b", "sort", (2, 4), None),
         ("qwen2-0.5b", None, (2, 4), 255)]


def _case(arch, dispatch, mesh, vocab):
    return f"{arch}|{dispatch or ''}|{mesh[0]}x{mesh[1]}|{vocab or ''}"


def _config(arch, dispatch=None, vocab=None, **moe):
    cfg = tcfg.get_config(arch).reduced()
    if vocab:
        cfg = dataclasses.replace(cfg, vocab=vocab)
    if dispatch or moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **({"dispatch": dispatch} if dispatch else {}), **moe))
    return cfg


@functools.lru_cache(maxsize=None)
def _weights(arch, dispatch, vocab):
    return tbuild(_config(arch, dispatch, vocab)).init(
        torch.Generator().manual_seed(1), device="cpu")


def _tokens(vocab):
    return np.random.default_rng(2).integers(0, vocab, BATCH).astype(np.int32)


def _mesh(shape, device="cpu"):
    if device == "meta":
        return make_mesh(shape, ("data", "model"), ["meta"] * math.prod(shape))
    return make_host_mesh(shape[1], devices=["cpu"] * math.prod(shape))


# The reference's side: every case in one process, one .npz out.
REF = r'''
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_disable_most_optimizations", True)   # compile time
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import ShapeCase
from repro.launch.steps import abstract_train_args
from repro.models import build_model
from repro.optim import AdamWConfig, adamw_init, adamw_update
from repro.parallel.sharding import sharding_rules
jobs, out_path = json.loads(sys.argv[1]), sys.argv[3]
weights = np.load(sys.argv[2])
out = {}

for job in jobs:
    cfg = get_config(job["arch"]).reduced()
    if job["vocab"]:
        cfg = dataclasses.replace(cfg, vocab=job["vocab"])
    if job["dispatch"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=job["dispatch"]))
    model = build_model(cfg)
    k = job["key"]
    tree = jax.tree.structure(jax.eval_shape(model.init,
                                             jax.random.PRNGKey(1)))
    params = jax.tree.unflatten(tree, [jnp.asarray(weights[f"{k}/w{i}"])
                                       for i in range(tree.num_leaves)])
    tokens = jnp.asarray(np.asarray(job["tokens"], np.int32))
    mesh = jax.make_mesh(tuple(job["mesh"]), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    specs, opt = model.specs(), AdamWConfig()

    def train_step(params, state, batch):
        loss, grads = jax.value_and_grad(model.loss)(params, batch)
        params, state, metrics = adamw_update(params, grads, state, opt,
                                              param_specs=specs)
        return loss, grads, params, state, metrics

    with sharding_rules(mesh), mesh:
        ap, ao, ab = abstract_train_args(model, ShapeCase(
            "t", tokens.shape[1], tokens.shape[0], "train"))
        put = lambda x, a: jax.device_put(x, jax.tree.map(
            lambda s: s.sharding, a))
        loss, g, p2, o2, m = jax.jit(train_step)(
            put(params, ap), put(adamw_init(params), ao),
            put({"tokens": tokens}, ab))
    out[k + "/loss"] = np.asarray(loss)
    out[k + "/grad_norm"] = np.asarray(m["grad_norm"])
    for name, t in (("g", g), ("p", p2), ("mu", o2["mu"]), ("nu", o2["nu"])):
        for i, x in enumerate(jax.tree.leaves(t)):
            out[f"{k}/{name}{i}"] = np.asarray(x)
    blocks = []
    for s in jax.tree.leaves(ao["mu"]):
        dm = s.sharding.devices_indices_map(tuple(s.shape))
        blocks.append([[[sl.start or 0, n if sl.stop is None else sl.stop]
                        for sl, n in zip(dm[d], s.shape)]
                       for d in mesh.devices.reshape(-1)])
    out[k + "/mu_blocks"] = np.asarray(json.dumps(blocks))
np.savez(out_path, **out)
print("OK")
'''


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny ops (the CPU
    ``index_add_`` of the ``'sort'`` region is far slower on many)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's subprocess of 8 fake devices, every case, started
    with the module and run beside its tests (a thread waits on it):
    ``(future, path of its .npz)``."""
    tmp = tmp_path_factory.mktemp("ref_train_partition")
    jobs = [{"key": _case(*c), "arch": c[0], "dispatch": c[1],
             "mesh": c[2], "vocab": c[3],
             "tokens": _tokens(c[3] or 256).tolist()} for c in CASES]
    np.savez(tmp / "weights.npz", **{
        f"{_case(*c)}/w{i}": w.numpy() for c in CASES
        for i, w in enumerate(sorted_leaves(_weights(c[0], c[1], c[3])))})
    argv = ["ref", json.dumps(jobs), str(tmp / "weights.npz"),
            str(tmp / "ref.npz")]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_with_devices, f"import sys\nsys.argv = "
                          f"{argv!r}\n" + REF, 8, timeout=600), \
            tmp / "ref.npz"


@pytest.fixture(scope="module")
def ref(reference_run, port):
    """The reference's results: the port's side of every case is made
    first, while the reference runs."""
    for c in CASES:
        port(*c)
    future, path = reference_run
    future.result()
    return dict(np.load(path))


def _grads(model, placed, batch):
    """The placed loss and each leaf's gradient (a ``Sharded`` laid out
    like the leaf, its partial sums added), by one backward."""
    live = [grad_leaves(p) for p in tree_leaves(placed)]
    with torch.enable_grad():
        loss = model.loss(tree_unflatten(placed, live), batch)
        grads = leaf_grads(loss, live)
    assert all(g.spec == p.spec for g, p in zip(grads, live))
    return float(loss.first().detach()), [reduce(g) for g in grads]


def _counted(fn):
    pmesh.reset_collectives()
    fn()
    return pmesh.collectives()


@pytest.fixture(scope="module")
def port():
    """``port(case)``: the port's loss, whole gradients (in tree order),
    the step's params and state after it, its collectives and the meta
    trace's, made once a case."""
    made = {}

    def get(arch, dispatch, shape, vocab):
        key = _case(arch, dispatch, shape, vocab)
        if key in made:
            return made[key]
        model = tbuild(_config(arch, dispatch, vocab))
        weights = _weights(arch, dispatch, vocab)
        batch = {"tokens": torch.from_numpy(_tokens(vocab or 256))}
        step = make_train_step(model, AdamWConfig())
        with sharding_rules(_mesh(shape)):
            # a block that is its whole leaf is the leaf: the step writes
            # it in place, so the shared weights are copied first
            placed = model.place(tree_map(torch.clone, weights))
            loss, grads = _grads(model, placed, batch)
            state = adamw_init(placed, model.specs())
            res = {}
            live = _counted(lambda: res.update(out=step(placed, state,
                                                        batch)))
        with sharding_rules(_mesh(shape, "meta")):
            meta = tree_map(lambda t: torch.empty_like(t, device="meta"),
                            weights)
            mp = model.place(meta)
            mo = adamw_init(mp, model.specs())
            traced = _counted(lambda: step(mp, mo, {
                "tokens": batch["tokens"].to("meta")}))
        made[key] = dict(loss=loss, grads=[g.whole() for g in grads],
                         out=res["out"], live=live,
                         meta=traced, model=model)
        return made[key]
    return get


def _within(got, want, tol, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


# ---------------------------------------------------------------------------
# The port alone, on four CPU devices
# ---------------------------------------------------------------------------

def test_layout_ops_carry_gradients():
    """Every layout op of ``parallel.sharding`` under autograd, on a (2, 2)
    mesh in float64: a row-split ``X`` times a column-split ``W``
    (``matmul``, ``smap``), regathered and cut again (``relayout``:
    an all-gather, ``split``), ``add``; a K-split product's partial sums
    reduced both ways (``reduce``: an all-reduce and a reduce-scatter);
    ``Sharded.whole`` of the sum. The gradients of each coordinate's
    blocks, added over the coordinates holding a block, equal the whole
    program's; the backward ran each collective's dual, counted."""
    from repro_torch.parallel.sharding import (add, matmul, relayout,
                                               replicated_axes, shard,
                                               smap, split)
    mesh = _mesh((2, 2))
    gen = torch.Generator().manual_seed(7)
    x, w = (torch.randn(s, generator=gen, dtype=torch.float64)
            for s in ((4, 6), (6, 8)))
    f64 = torch.float64

    def program(x, w, placed):
        if not placed:
            y = x @ w
            return ((y + y) ** 2).sum() + 3 * y.sum()
        y = matmul(x["rows"], w["cols"], f64)            # (data, model)
        y2 = split(relayout(y, ("data", None)), 1, "model")
        q = add(y2, y)
        k = matmul(x["k"], w["k"], f64)                  # partial, model
        r = reduce(k).whole().sum() \
            + 2 * relayout(k, ("model", None)).whole().sum()
        return (smap(lambda a: a ** 2, q, spec=q.spec).whole()).sum() + r
    specs = {"rows": ("data", None), "k": (None, "model")}, \
        {"cols": (None, "model"), "k": ("model", None)}
    xs = {k: grad_leaves(shard(x, sp, mesh)) for k, sp in specs[0].items()}
    ws = {k: grad_leaves(shard(w, sp, mesh)) for k, sp in specs[1].items()}
    pmesh.reset_collectives()
    loss = program(xs, ws, True)
    leaves = list(xs.values()) + list(ws.values())
    got = torch.autograd.grad(loss, [b for t in leaves
                                     for b in t.blocks.values()])
    kinds = pmesh.collectives()[1]
    assert kinds["all-gather"] == 2 and kinds["reduce-scatter"] == 2
    assert kinds["all-reduce"] == 2
    xw, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(program(xw, ww, False), [xw, ww])
    assert abs(float(loss.detach()) - float(program(x, w, False))) <= \
        1e-12 * abs(float(loss.detach()))
    # X and W each enter through two layouts; each block's gradient sums
    # over the coordinates holding it
    it, acc = iter(got), [torch.zeros_like(x), torch.zeros_like(w)]
    for t, i in zip(leaves, (0, 0, 1, 1)):
        assert replicated_axes(t) == tuple(
            a for a in ("data", "model") if a not in t.spec)
        for c in mesh_coords(mesh):
            acc[i][t.index(c)] += next(it)
    for a, full in zip(acc, want):
        torch.testing.assert_close(a, full, rtol=1e-12, atol=1e-12)


WHOLE_CASES = [("granite-moe-3b-a800m", "sort", (2, 2), {}),
               ("granite-moe-3b-a800m", "spmm", (1, 4), {}),
               ("granite-moe-3b-a800m", "ellpack", (2, 2), {}),
               ("granite-moe-3b-a800m", "spmm", (2, 2), {"n_experts": 6}),
               ("deepseek-v2-lite-16b", "sort", (1, 4), {}),
               ("qwen2-0.5b", None, (1, 4), {}),
               ("internvl2-2b", None, (2, 2), {})]


@pytest.mark.parametrize("arch,dispatch,shape,moe", WHOLE_CASES,
                         ids=[f"{a}|{d or ''}|{s[0]}x{s[1]}|{len(m)}"
                              for a, d, s, m in WHOLE_CASES])
def test_placed_step_equals_whole_weights(arch, dispatch, shape, moe):
    """The placed step against the same step on whole weights under the
    same rules: the loss within 2e-6 relative, each gradient within 2e-6
    of its max; the ``'spmm'`` and ``'ellpack'`` layers never gather
    (``Sharded.whole`` is not called), with experts split on ``"model"``
    and with 6 experts replicated and their hidden dim split;
    internvl2-2b's patch prefix masked out of the targets."""
    cfg = _config(arch, dispatch, **moe)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(
        3, cfg.vocab, (4, 8)).astype(np.int32))}
    if cfg.n_vision_tokens:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    with sharding_rules(_mesh(shape)):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        want = model.loss(params, batch)
        wg = torch.autograd.grad(want, leaves)
        placed = model.place(tree_map(lambda t: t.detach(), params))
        orig = Sharded.whole

        def no_gather(self):
            raise AssertionError("a placed layer gathered a tensor whole")
        Sharded.whole = no_gather
        try:
            loss, grads = _grads(model, placed, batch)
        finally:
            Sharded.whole = orig
    assert abs(loss - float(want)) <= WTOL * abs(float(want))
    for (path, _), g, w in zip(tree_items(params), grads, wg):
        _within(g.whole(), w.numpy(), WTOL, path)


def test_checkpoint_restores_onto_any_mesh(tmp_path):
    """A placed step's params and moments saved on (2, 2) restore bit for
    bit onto (1, 4) (laid out by the placed trees given) and whole; the
    format is the reference's, whose manager restores it, and a
    checkpoint the reference writes restores onto a port mesh."""
    from repro.checkpoint import CheckpointManager as RefManager
    model = tbuild(_config("granite-moe-3b-a800m"))
    specs = model.specs()
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(256))}
    with sharding_rules(_mesh((2, 2))):
        placed = model.place(params)
        state = adamw_init(placed, specs)
        placed, state, _ = make_train_step(model, AdamWConfig())(
            placed, state, batch)
        CheckpointManager(str(tmp_path / "port")).save(1, placed, state)
    whole = (tree_map(lambda t: t.whole(), placed),
             {"mu": tree_map(lambda t: t.whole(), state["mu"]),
              "nu": tree_map(lambda t: t.whole(), state["nu"]),
              "step": state["step"]})
    mgr = CheckpointManager(str(tmp_path / "port"))
    with sharding_rules(_mesh((1, 4))) as rules:
        like = model.place(params, adamw_init(params))
        p14, o14, _ = mgr.restore(1, *like, device="cpu")
        assert all(isinstance(t, Sharded) and t.mesh is rules.mesh
                   for t in tree_leaves((p14, o14["mu"], o14["nu"])))
    p1, o1, _ = mgr.restore(1, params, adamw_init(params), device="cpu")
    for got in ((p14, o14), (p1, o1)):
        for a, b in zip(tree_leaves(whole), tree_leaves(got)):
            b = b.whole() if isinstance(b, Sharded) else b
            assert a.dtype == b.dtype and torch.equal(a, b)
    as_np = (lambda tree: tree_map(lambda t: t.numpy(), tree))
    rp, _, _ = RefManager(str(tmp_path / "port")).restore(
        1, as_np(whole[0]), as_np(whole[1]))
    for (path, a), b in zip(tree_items(whole[0], sort=True),
                            sorted_leaves(rp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), path)
    # the reference writes, the port restores onto a (2, 2) mesh
    ref_tree = {"a": np.arange(32, dtype=np.float32).reshape(4, 8)}
    RefManager(str(tmp_path / "ref")).save(
        3, ref_tree, {"mu": {"a": np.ones((4, 8), np.float32)},
                      "step": np.int32(3)})
    mesh = _mesh((2, 2))
    from repro_torch.parallel.sharding import shard
    like = {"a": shard(torch.zeros(4, 8), ("data", "model"), mesh)}
    got, opt, _ = CheckpointManager(str(tmp_path / "ref")).restore(
        3, like, {"mu": like, "step": torch.zeros((), dtype=torch.int32)},
        device="cpu")
    assert got["a"].spec == ("data", "model")
    assert torch.equal(got["a"].whole(), torch.from_numpy(ref_tree["a"]))
    assert torch.equal(opt["mu"]["a"].whole(), torch.ones(4, 8))


def test_launch_train_partitioned_and_resumes(tmp_path):
    """``launch.train.main(["--model-parallel", "2", ...], devices=["cpu"]
    * 4)`` trains the reduced granite partitioned (params and moments
    placed on (2, 2); its first loss is the whole weights' loss of the
    same batch under the same rules, within 2e-6), checkpoints, and a
    second run with ``--model-parallel 4`` resumes onto (1, 4) from that
    step."""
    argv = ["--arch", "granite-moe-3b-a800m", "--smoke", "--batch", "4",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--log-every", "1"]
    out = tlaunch.main(argv + ["--steps", "4", "--ckpt-every", "4",
                               "--model-parallel", "2"],
                       devices=["cpu"] * 4)
    assert out["mesh"].shape == {"data": 2, "model": 2}
    assert all(isinstance(t, Sharded) for t in tree_leaves(
        (out["params"], out["opt_state"]["mu"])))
    losses = [h["loss"] for h in out["history"]]
    assert all(math.isfinite(x) for x in losses)
    tr = out["trainer"]
    with sharding_rules(out["mesh"]), torch.no_grad():
        want = float(tr.model.loss(tr.model.init(
            torch.Generator().manual_seed(tr.tcfg.seed), device="cpu"),
            tr._batch(0)))
    assert abs(losses[0] - want) <= WTOL * abs(want)
    again = tlaunch.main(argv + ["--steps", "6", "--ckpt-every", "100",
                                 "--model-parallel", "4"],
                         devices=["cpu"] * 4)
    assert [h["step"] for h in again["history"]] == [4, 5]
    assert next(iter(tree_leaves(again["params"]))).mesh.shape == {
        "data": 1, "model": 4}
    assert int(again["opt_state"]["step"]) == 6


# ---------------------------------------------------------------------------
# Against the reference's sharded train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dispatch,mesh,vocab", CASES,
                         ids=[_case(*c) for c in CASES])
def test_loss_and_grads_match_sharded_reference(ref, port, arch, dispatch,
                                                mesh, vocab):
    """The placed loss within 1e-5 relative of the reference's jitted one;
    every placed leaf's gradient, its partial sums added, within 2e-5 of
    its max of the reference's, in the reference's leaf order."""
    key = _case(arch, dispatch, mesh, vocab)
    got = port(arch, dispatch, mesh, vocab)
    want = float(ref[key + "/loss"])
    assert abs(got["loss"] - want) <= RTOL * abs(want)
    weights = _weights(arch, dispatch, vocab)
    by_path = dict(zip((p for p, _ in tree_items(weights)), got["grads"]))
    for i, (path, _) in enumerate(tree_items(weights, sort=True)):
        _within(by_path[path], ref[f"{key}/g{i}"], GTOL, path)


@pytest.mark.parametrize("arch,dispatch,mesh,vocab", CASES,
                         ids=[_case(*c) for c in CASES])
def test_train_step_matches_sharded_reference(ref, port, arch, dispatch,
                                              mesh, vocab):
    """One ZeRO-1 step: the grad norm within 1e-5 relative, the moments
    within 1e-5 of their max, each parameter within 1e-6 where its
    gradient's sign is well determined and two steps' size elsewhere (the
    tolerance of ``tests/test_torch_lm_mesh.py``'s train step), and each
    moment's blocks, coordinate by coordinate, the slices JAX's
    ``devices_indices_map`` gives the reference's moments."""
    key = _case(arch, dispatch, mesh, vocab)
    got = port(arch, dispatch, mesh, vocab)
    p2, o2, m = got["out"]
    want = float(ref[key + "/grad_norm"])
    assert abs(float(m["grad_norm"]) - want) <= RTOL * abs(want)
    lr1 = AdamWConfig().lr / max(1, AdamWConfig().warmup_steps)
    blocks = json.loads(str(ref[key + "/mu_blocks"]))
    for i, (p, mu, nu) in enumerate(zip(sorted_leaves(p2),
                                        sorted_leaves(o2["mu"]),
                                        sorted_leaves(o2["nu"]))):
        assert isinstance(mu, Sharded) and isinstance(p, Sharded)
        want_mu = ref[f"{key}/mu{i}"]
        _within(mu.whole(), want_mu, RTOL, ("mu", i))
        _within(nu.whole(), ref[f"{key}/nu{i}"], RTOL, ("nu", i))
        err = np.abs(p.whole().numpy() - ref[f"{key}/p{i}"])
        sure = np.abs(want_mu) > 1e-3 * np.abs(want_mu).max()
        assert float(err[sure].max(initial=0)) <= 1e-6, ("p", i)
        assert float(err.max()) <= 2 * lr1 + 1e-6, ("p", i)
        assert [[[s.start, s.stop] for s in mu.index(c)]
                for c in mesh_coords(mu.mesh)] == blocks[i], ("blocks", i)


@pytest.mark.parametrize("arch,dispatch,mesh,vocab", CASES,
                         ids=[_case(*c) for c in CASES])
def test_step_collectives_equal_meta_trace(port, arch, dispatch, mesh,
                                           vocab):
    """One step's collectives on the CPU mesh equal, kind by kind, the
    same step traced on a meta mesh of that shape (one coordinate
    standing for all), the backward's duals and the remat's recompute
    included; the gradients' reduce-scatters ran."""
    got = port(arch, dispatch, mesh, vocab)
    assert got["live"] == got["meta"]
    assert got["live"][1]["reduce-scatter"] > 0
    assert got["live"][1]["all-reduce"] > 0
