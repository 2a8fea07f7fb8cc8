"""repro_torch's partitioned programs of the SSM, RG-LRU and
encoder-decoder families against the reference's own sharded programs on
the CPU.

Under ``sharding_rules(mesh)`` with the weights placed (``Model.place``)
falcon-mamba's Mamba mixers, recurrentgemma's RG-LRU and ``local``
attention blocks and whisper's encoder, decoder and cross-attention run
block by block with counted collectives: prefill (the caches laid out by
``launch.steps.cache_shardings``), decode and the loss with its backward
(``parallel.sharding.leaf_grads``). The reference runs in one subprocess
with 8 fake CPU devices (``conftest.run_with_devices``, Auto axes, most
XLA optimizations off, as ``tests/test_torch_lm_train_partition.py`` runs
it): ``jax.jit`` of its prefill, decode step and ``value_and_grad`` of its
loss, the weights put on the mesh by ``param_shardings``, the cache by
``cache_shardings``. The port draws the weights and hands them over; it
runs on ``make_host_mesh(m, ["cpu"] * 8)``.

Reference cases, on (2, 4) and (1, 8): the reduced falcon-mamba-7b over
three 16-token scan chunks, the reduced recurrentgemma-9b (its window of
8 slots) with prompts of 5 and 12 tokens, on both sides of the window
(the loss and gradients on the 12), and the reduced whisper-medium with
its 16 frames. Port-only cases run on ``["cpu"] * 4``.
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
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model as tbuild
from repro_torch.models import transformer
from repro_torch.models.params import (sorted_leaves, tree_items, tree_leaves,
                                       tree_map, tree_unflatten)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import make_mesh, sharding_rules
from repro_torch.parallel import mesh as pmesh
from repro_torch.parallel.sharding import (Sharded, grad_leaves, leaf_grads,
                                           mesh_coords, reduce)

RTOL = 1e-5              # logits (of their max), the loss (relative)
GTOL = 2e-5              # each gradient leaf, of its max
WTOL = 2e-6              # placed against whole weights on the port alone,
                         # in float64 (the float32 islands, states and
                         # softmax, leave ~2e-7)
BATCH, STEPS, S_MAX = 4, 4, 64
CASES = [("falcon-mamba-7b", (2, 4), 48), ("falcon-mamba-7b", (1, 8), 48),
         ("recurrentgemma-9b", (2, 4), 5), ("recurrentgemma-9b", (2, 4), 12),
         ("recurrentgemma-9b", (1, 8), 5), ("recurrentgemma-9b", (1, 8), 12),
         ("whisper-medium", (2, 4), 8), ("whisper-medium", (1, 8), 8)]
# the loss and its gradients: once a config and mesh (the RG-LRU's past
# its window), each a jitted backward of ~3 s in the reference
GRAD_CASES = [c for c in CASES if c[0] != "recurrentgemma-9b" or c[2] > 8]


def _case(arch, mesh, seq):
    return f"{arch}|{mesh[0]}x{mesh[1]}|{seq}"


def _config(arch):
    return tcfg.get_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def _weights(arch):
    return tbuild(_config(arch)).init(torch.Generator().manual_seed(1),
                                      device="cpu")


@functools.lru_cache(maxsize=None)
def _inputs(arch, seq):
    """The prompt (B, seq), the decode steps' tokens (B, STEPS) and, for
    whisper, the frames: numpy, from one seed."""
    cfg = _config(arch)
    rng = np.random.default_rng(2)
    toks = rng.integers(3, cfg.vocab, (BATCH, seq)).astype(np.int32)
    steps = rng.integers(3, cfg.vocab, (BATCH, STEPS)).astype(np.int32)
    frames = (rng.standard_normal((BATCH, cfg.encoder_seq, cfg.d_model))
              .astype(np.float32) if cfg.family == "audio" else None)
    return toks, steps, frames


def _batch(arch, seq, device="cpu"):
    toks, _, frames = _inputs(arch, seq)
    out = {"tokens": torch.from_numpy(toks).to(device)}
    if frames is not None:
        out["frames"] = torch.from_numpy(frames).to(device)
    return out


def _mesh(shape, device="cpu"):
    if device == "meta":
        return make_mesh(shape, ("data", "model"), ["meta"] * math.prod(shape))
    return make_host_mesh(shape[1], devices=["cpu"] * math.prod(shape))


# The reference's side: every case in one process, one .npz out.
REF = r'''
import concurrent.futures, json, sys
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_disable_most_optimizations", True)   # compile time
from jax.sharding import AxisType, NamedSharding
from repro.configs import get_config
from repro.launch.steps import cache_shardings
from repro.models import build_model
from repro.parallel.sharding import current_rules, sharding_rules
jobs, out_path = json.loads(sys.argv[1]), sys.argv[3]
weights = np.load(sys.argv[2])
out = {}

def key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)

def blocks(tree, mesh):
    res = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        m = leaf.sharding.devices_indices_map(tuple(leaf.shape))
        res[key(path)] = [[list(pos), [[s.start or 0, n if s.stop is None
                                         else s.stop]
                                        for s, n in zip(m[d], leaf.shape)]]
                          for pos, d in np.ndenumerate(mesh.devices)]
    return res

def run(group):
    """One config on one mesh, in a thread of its own: the rules and the
    mesh context are the thread's, so the groups compile side by side."""
    arch, shape = group[0]["arch"], tuple(group[0]["mesh"])
    model = build_model(get_config(arch).reduced())
    tree = jax.tree.structure(jax.eval_shape(model.init,
                                             jax.random.PRNGKey(1)))
    params = jax.tree.unflatten(tree, [jnp.asarray(weights[f"{arch}/w{i}"])
                                       for i in range(tree.num_leaves)])
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    s_max = group[0]["s_max"]
    prefill = jax.jit(lambda p, b: model.prefill(p, b, s_max))
    decode = jax.jit(model.decode_step)
    grad = jax.jit(jax.value_and_grad(model.loss))
    with sharding_rules(mesh), mesh:
        rules = current_rules()
        lay = lambda x: jax.device_put(x, NamedSharding(mesh, rules.resolve(
            ("batch",) + (None,) * (x.ndim - 1), x.shape)))
        params = jax.device_put(params, jax.tree.map(
            lambda s: s.sharding, model.abstract_params()))
        for job in group:
            k = job["key"]
            batch = {n: lay(jnp.asarray(weights[f"{k}/{n}"]))
                     for n in job["batch"]}
            logits, cache = prefill(params, batch)
            out[k + "/logits0"] = np.asarray(logits)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    cache["layers"])[0]:
                out[f"{k}/cache/layers/{key(path)}"] = np.asarray(leaf)
            cache = jax.device_put(cache, cache_shardings(cache))
            steps = weights[f"{k}/steps"]
            for t in range(steps.shape[1]):
                logits, cache = decode(params, cache, lay(jnp.asarray(
                    steps[:, t:t + 1])))
                out[f"{k}/logits{t + 1}"] = np.asarray(logits)
            if job["grad"]:
                loss, g = grad(params, batch)
                out[k + "/loss"] = np.asarray(loss)
                for i, x in enumerate(jax.tree.leaves(g)):
                    out[f"{k}/g{i}"] = np.asarray(x)
            shapes = jax.eval_shape(lambda: model.cache_zeros(
                steps.shape[0], s_max))
            shapes = jax.tree.map(lambda s, sh: jax.ShapeDtypeStruct(
                s.shape, s.dtype, sharding=sh), shapes,
                cache_shardings(shapes))
            out[k + "/blocks"] = np.asarray(json.dumps(
                blocks({"layers": shapes["layers"]}, mesh)))

groups = {}
for job in jobs:
    groups.setdefault((job["arch"], tuple(job["mesh"])), []).append(job)
with concurrent.futures.ThreadPoolExecutor(len(groups)) as pool:
    list(pool.map(run, groups.values()))
np.savez(out_path, **out)
print("OK")
'''


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's subprocess of 8 fake devices, every case, started
    with the module and run beside its tests (a thread waits on it):
    ``(future, path of its .npz)``."""
    tmp = tmp_path_factory.mktemp("ref_families_partition")
    jobs, arrays = [], {}
    for arch, mesh, seq in CASES:
        key = _case(arch, mesh, seq)
        toks, steps, frames = _inputs(arch, seq)
        arrays.update({f"{key}/tokens": toks, f"{key}/steps": steps})
        if frames is not None:
            arrays[f"{key}/frames"] = frames
        jobs.append({"key": key, "arch": arch, "mesh": mesh, "s_max": S_MAX,
                     "grad": (arch, mesh, seq) in GRAD_CASES,
                     "batch": ["tokens"] + (["frames"] if frames is not None
                                            else [])})
    np.savez(tmp / "weights.npz", **arrays, **{
        f"{arch}/w{i}": w.numpy() for arch in {c[0] for c in CASES}
        for i, w in enumerate(sorted_leaves(_weights(arch)))})
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


def _counted(fn):
    pmesh.reset_collectives()
    res = fn()
    return res, pmesh.collectives()


def _serve(model, params, batch, steps):
    """Prefill and the decode steps fed ``steps`` (B, STEPS): each step's
    logits, whole, the cache after the prefill (whole leaves by path, its
    placed leaves' index maps) and the collectives of the prefill and of
    one decode step."""
    whole = (lambda t: t if isinstance(t, torch.Tensor) else t.whole())
    (logits, cache), pre = _counted(lambda: model.prefill(params, batch,
                                                          S_MAX))
    outs = [whole(logits)]
    items = tree_items({"layers": cache["layers"]}, sort=True)
    values = {p: whole(t).clone() for p, t in items}
    maps = {p: [[list(c), [[s.start, s.stop] for s in t.index(c)]]
                for c in mesh_coords(t.mesh)] for p, t in items
            if isinstance(t, Sharded)}
    dec = None
    for t in range(steps.shape[1]):
        (logits, cache), got = _counted(lambda: model.decode_step(
            params, cache, steps[:, t:t + 1]))
        dec = dec or got
        outs.append(whole(logits))
    return dict(logits=outs, cache=values, maps=maps, prefill=pre,
                decode=dec)


def _grads(model, placed, batch):
    """The placed loss and each leaf's gradient (its partial sums added,
    whole), by one backward."""
    live = [grad_leaves(p) for p in tree_leaves(placed)]
    with torch.enable_grad():
        loss = model.loss(tree_unflatten(placed, live), batch)
        grads = leaf_grads(loss, live)
    assert all(g.spec == p.spec for g, p in zip(grads, live))
    return float(loss.first().detach()), [reduce(g).whole() for g in grads]


@pytest.fixture(scope="module")
def port():
    """``port(case)``: the port's served logits, cache, loss and whole
    gradients on the placed weights, its collectives of a prefill, a
    decode step and a training step, and the same three traced on a meta
    mesh, made once a case."""
    made = {}

    def get(arch, shape, seq):
        key = _case(arch, shape, seq)
        if key in made:
            return made[key]
        model = tbuild(_config(arch))
        weights = _weights(arch)
        batch = _batch(arch, seq)
        steps = torch.from_numpy(_inputs(arch, seq)[1])
        train = make_train_step(model, AdamWConfig())
        with sharding_rules(_mesh(shape)):
            placed = model.place(tree_map(torch.clone, weights))
            res = _serve(model, placed, batch, steps)
            res["loss"], res["grads"] = _grads(model, placed, batch)
            state = adamw_init(placed, model.specs())
            _, res["train"] = _counted(lambda: train(placed, state, batch))
        with sharding_rules(_mesh(shape, "meta")):
            mp = model.place(tree_map(
                lambda t: torch.empty_like(t, device="meta"), weights))
            mb = _batch(arch, seq, "meta")
            (_, cache), pre = _counted(lambda: model.prefill(mp, mb, S_MAX))
            _, dec = _counted(lambda: model.decode_step(
                mp, cache, steps[:, :1].to("meta")))
            _, tr = _counted(lambda: train(mp, adamw_init(mp, model.specs()),
                                           mb))
        res["meta"] = dict(prefill=pre, decode=dec, train=tr)
        made[key] = res
        return res
    return get


def _within(got, want, tol, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


# ---------------------------------------------------------------------------
# Against the reference's sharded programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,mesh,seq", CASES,
                         ids=[_case(*c) for c in CASES])
def test_serving_matches_sharded_reference(ref, port, arch, mesh, seq):
    """The placed prefill's logits and the 4 decode steps' after it, fed
    the same tokens, each within 1e-5 of its max of the reference's
    jitted prefill and decode steps; the cache after the prefill (the
    Mamba and RG-LRU states by channel, the ring's slots on both sides of
    its window, whisper's cross keys by heads) within 1e-5 of the
    reference's."""
    key = _case(arch, mesh, seq)
    got = port(arch, mesh, seq)
    for t, logits in enumerate(got["logits"]):
        _within(logits, ref[f"{key}/logits{t}"], RTOL, ("logits", t))
    for path, t in got["cache"].items():
        want = ref[f"{key}/cache/{path}"]
        if t.dtype == torch.int32:
            assert np.array_equal(t.numpy(), want), path
        else:
            _within(t, want, RTOL, path)


@pytest.mark.parametrize("arch,mesh,seq", GRAD_CASES,
                         ids=[_case(*c) for c in GRAD_CASES])
def test_loss_and_grads_match_sharded_reference(ref, port, arch, mesh, seq):
    """The placed loss within 1e-5 relative of the reference's jitted one;
    every placed leaf's gradient, its partial sums added, within 2e-5 of
    its max of the reference's, in the reference's leaf order."""
    key = _case(arch, mesh, seq)
    got = port(arch, mesh, seq)
    want = float(ref[key + "/loss"])
    assert abs(got["loss"] - want) <= RTOL * abs(want)
    weights = _weights(arch)
    by_path = dict(zip((p for p, _ in tree_items(weights)), got["grads"]))
    for i, (path, _) in enumerate(tree_items(weights, sort=True)):
        _within(by_path[path], ref[f"{key}/g{i}"], GTOL, path)


@pytest.mark.parametrize("arch,mesh,seq", CASES,
                         ids=[_case(*c) for c in CASES])
def test_cache_blocks_match_devices_indices_map(ref, port, arch, mesh, seq):
    """Every cache leaf's blocks, coordinate by coordinate, are where JAX's
    ``devices_indices_map`` puts them: the states by batch and channel,
    the rings and the self-attention caches by batch and sequence,
    ``ck``/``cv`` by heads, ``slot_pos`` whole."""
    got = port(arch, mesh, seq)["maps"]
    want = json.loads(str(ref[_case(arch, mesh, seq) + "/blocks"]))
    assert sorted(got) == sorted(p for p in want)
    for path, m in got.items():
        assert m == want[path], path


@pytest.mark.parametrize("arch,mesh,seq", CASES,
                         ids=[_case(*c) for c in CASES])
def test_collectives_equal_meta_trace(port, arch, mesh, seq):
    """A prefill's, a decode step's and a training step's collectives on
    the CPU mesh equal, kind by kind, the same calls traced on a meta mesh
    of that shape; the mixers' and cross-attention's collectives ran."""
    got = port(arch, mesh, seq)
    for what in ("prefill", "decode", "train"):
        assert got[what] == got["meta"][what], what
    assert got["decode"][1]["all-reduce"] > 0
    assert got["train"][1]["reduce-scatter"] > 0


# ---------------------------------------------------------------------------
# The port alone, on four CPU devices
# ---------------------------------------------------------------------------

WHOLE_CASES = [(a, m, s) for a, s in (("falcon-mamba-7b", 48),
                                      ("recurrentgemma-9b", 12),
                                      ("whisper-medium", 8))
               for m in ((2, 2), (1, 4))]


@pytest.mark.parametrize("arch,shape,seq", WHOLE_CASES,
                         ids=[_case(*c) for c in WHOLE_CASES])
def test_placed_equals_whole_weights(arch, shape, seq):
    """The placed prefill, 4 decode steps, loss and every gradient against
    the same calls on whole weights under the same rules, in float64,
    within 2e-6 of their max; no placed path gathers a tensor whole
    (``Sharded.whole`` is not called)."""
    cfg = dataclasses.replace(_config(arch), param_dtype=torch.float64,
                              compute_dtype=torch.float64)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in _batch(arch, seq).items()}
    steps = torch.from_numpy(_inputs(arch, seq)[1])
    runs = []
    with sharding_rules(_mesh(shape)):
        for placed in (False, True):
            p = model.place(params) if placed else params
            orig = Sharded.whole

            def no_gather(self):
                raise AssertionError("a placed layer gathered a tensor "
                                     "whole")
            outs = []
            Sharded.whole = no_gather
            try:
                logits, cache = model.prefill(p, batch, S_MAX)
                outs.append(logits)
                for t in range(STEPS):
                    logits, cache = model.decode_step(p, cache,
                                                      steps[:, t:t + 1])
                    outs.append(logits)
                if placed:
                    live = [grad_leaves(x) for x in tree_leaves(p)]
                    with torch.enable_grad():
                        loss = model.loss(tree_unflatten(p, live), batch)
                        grads = [reduce(g) for g in leaf_grads(loss, live)]
                    loss = loss.first()
                else:
                    leaves = [t.clone().requires_grad_(True)
                              for t in tree_leaves(p)]
                    with torch.enable_grad():
                        loss = model.loss(tree_unflatten(p, leaves), batch)
                        grads = torch.autograd.grad(loss, leaves)
            finally:
                Sharded.whole = orig
            whole = (lambda t: t if isinstance(t, torch.Tensor)
                     else t.whole())
            runs.append(([whole(t) for t in outs], float(loss.detach()),
                         [whole(g) for g in grads]))
    (wl, wloss, wg), (gl, gloss, gg) = runs
    assert abs(gloss - wloss) <= WTOL * abs(wloss)
    for t, (a, b) in enumerate(zip(gl, wl)):
        _within(a, b.numpy(), WTOL, ("logits", t))
    for (path, _), a, b in zip(tree_items(params), gg, wg):
        _within(a, b.numpy(), WTOL, path)


@pytest.mark.parametrize("s", (1, 5, 8, 11, 16, 19))
def test_ring_positions_match_ring_layout(s):
    """Each shard's slots of a ``local`` block's ring (W = 8 in blocks of
    2), gathered from the prefill's whole keys, are ``_ring_layout``'s
    roll of the last W keys, and ``ring_positions`` its slot positions:
    prompts shorter than, equal to and past the window."""
    w = 8
    k = torch.randn(2, s, 1, 4, generator=torch.Generator().manual_seed(s))
    want_k, _, want_pos = transformer._ring_layout(k, k, s, w)
    full = torch.zeros(2, w, 1, 4)
    full[:, :want_k.shape[1]] = want_k
    got = torch.cat([transformer._ring_block(k, s, w, lo, 2)
                     for lo in range(0, w, 2)], dim=1)
    assert torch.equal(got, full)
    assert torch.equal(transformer.ring_positions(s, w, 0, w, "cpu")
                       .to(torch.int32), want_pos)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_launch_serve_partitioned(arch):
    """``launch.serve.main(["--model-parallel", "2", ...], devices=["cpu"]
    * 4)`` serves three requests of the reduced SSM and hybrid configs on
    weights placed on (2, 2); its counters equal the one-device run's."""
    argv = ["--arch", arch, "--smoke", "--requests", "3", "--max-new", "4",
            "--model-parallel", "2"]
    eng = tserve.main(argv, devices=["cpu"] * 4)
    assert all(isinstance(t, Sharded) and t.mesh.shape == {"data": 2,
                                                           "model": 2}
               for t in tree_leaves(eng.params))
    again = tserve.main(argv[:-2] + ["--device", "cpu"])
    for k in ("requests", "tokens", "decode_steps"):
        assert eng.stats()[k] == again.stats()[k], k


def test_launch_train_partitioned_and_resumes(tmp_path):
    """``launch.train.main(["--model-parallel", "2", ...], devices=["cpu"]
    * 4)`` trains whisper's reduced config partitioned (params and moments
    placed on (2, 2); its first loss is the whole weights' loss of the
    same batch under the same rules, within 2e-6), checkpoints, and a
    second run with ``--model-parallel 4`` resumes onto (1, 4) from that
    step."""
    argv = ["--arch", "whisper-medium", "--smoke", "--batch", "4", "--seq",
            "16", "--ckpt-dir", str(tmp_path), "--log-every", "1"]
    out = tlaunch.main(argv + ["--steps", "3", "--ckpt-every", "3",
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
    again = tlaunch.main(argv + ["--steps", "5", "--ckpt-every", "100",
                                 "--model-parallel", "4"],
                         devices=["cpu"] * 4)
    assert [h["step"] for h in again["history"]] == [3, 4]
    assert next(iter(tree_leaves(again["params"]))).mesh.shape == {
        "data": 1, "model": 4}
    assert int(again["opt_state"]["step"]) == 5
