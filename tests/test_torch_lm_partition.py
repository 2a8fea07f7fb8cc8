"""repro_torch's partitioned serving program against the reference's own
sharded program on the CPU.

Under ``sharding_rules(mesh)`` the serving engine places the weights on
the mesh by the logical-axis rules (``Model.place``), prefill lays the
caches out by ``launch.steps.cache_shardings`` and every layer runs block
by block with counted collectives (``parallel.sharding.Sharded``). The
reference runs in one subprocess a mesh with 8 fake CPU devices
(``conftest.run_with_devices``, Auto axes, as ``tests/test_torch_lm_mesh.py``
builds them): its ``ServingEngine`` serves a wave, its jitted prefill gives
the wave's logits, and its ``NamedSharding.devices_indices_map`` gives
each leaf's blocks. The port runs the same weights on
``make_host_mesh(m, ["cpu"] * 8)``.

Cases: the reduced deepseek-v2-lite-16b (MLA, MoE ``'sort'``, shared
experts), granite-moe-3b-a800m (GQA, MoE ``'sort'``) and qwen2-0.5b (GQA
with QKV bias, tied vocab) on (1, 8), (2, 4) and (4, 2), and qwen2-0.5b
with a vocab of 255 on (2, 4), which no ``"model"`` axis divides. The
reduced configs have 4 heads, 2 kv heads and ``head_dim`` 16, so ``wk``'s
32 flat lanes split inside a head on a ``"model"`` axis of 4 or 8 and the
heads replicate on 8. Prefill logits are held within 1e-5 of their max,
greedy tokens equal; every placed leaf's blocks equal JAX's; the
collectives of a prefill and a decode step equal a count derived here from
the shapes and the meta trace's count of the same call. The port draws
the weights and hands them to the reference, which runs with most XLA
optimizations off: that halves its compile time.
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
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models.params import (place_params, sorted_leaves,
                                       tree_items, tree_map)
from repro_torch.parallel import make_mesh, sharding_rules
from repro_torch.parallel import mesh as pmesh
from repro_torch.parallel.sharding import Sharded, mesh_coords
from repro_torch.serve import ServeConfig, ServingEngine

RTOL = 1e-5
MESHES = ((1, 8), (2, 4), (4, 2))
ARCHS = ("deepseek-v2-lite-16b", "granite-moe-3b-a800m", "qwen2-0.5b")
CASES = [(a, m, None) for a in ARCHS for m in MESHES] + [
    ("qwen2-0.5b", (2, 4), 255)]
SERVE = dict(max_batch=4, max_new_tokens=5, s_max=32)
CALL = (4, 16)           # the counted prefill's tokens


def _case(arch, mesh, vocab):
    return f"{arch}|{mesh[0]}x{mesh[1]}|{vocab or ''}"


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(3, vocab, int(n)).astype(np.int32)
            for n in (5, 11, 8, 14)]


def _padded(prompts, eos=2):
    toks = np.full((len(prompts), max(map(len, prompts))), eos, np.int32)
    for i, p in enumerate(prompts):
        toks[i, toks.shape[1] - len(p):] = p
    return toks


# The reference's side: one mesh's jobs in, one .npz out.
REF = r'''
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_disable_most_optimizations", True)   # compile time
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch.steps import cache_shardings
from repro.models import build_model
from repro.parallel.sharding import sharding_rules
from repro.serve import ServeConfig, ServingEngine
jobs, shape, serve = (json.loads(a) for a in sys.argv[1:4])
weights, out_path = np.load(sys.argv[4]), sys.argv[5]
mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}

def key(path):
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)

def blocks(tree):
    res = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        m = leaf.sharding.devices_indices_map(tuple(leaf.shape))
        res[key(path)] = [[list(pos), [[s.start or 0, n if s.stop is None
                                         else s.stop]
                                        for s, n in zip(m[d], leaf.shape)]]
                          for pos, d in np.ndenumerate(mesh.devices)]
    return res

for job in jobs:
    cfg = get_config(job["arch"]).reduced()
    if job["vocab"]:
        cfg = dataclasses.replace(cfg, vocab=job["vocab"])
    model = build_model(cfg)
    k = job["key"]
    tree = jax.tree.structure(jax.eval_shape(model.init,
                                             jax.random.PRNGKey(1)))
    params = jax.tree.unflatten(tree, [jnp.asarray(weights[f"{k}/w{i}"])
                                       for i in range(tree.num_leaves)])
    with sharding_rules(mesh), mesh:
        eng = ServingEngine(model, params, ServeConfig(**serve))
        got = eng.generate_batch([np.asarray(p, np.int32)
                                  for p in job["prompts"]])
        out[k + "/tokens"] = np.asarray(json.dumps(got))
        logits, _ = eng._prefill(params, {"tokens": jnp.asarray(
            np.asarray(job["padded"], np.int32))})
        out[k + "/logits"] = np.asarray(logits)
        cache = jax.eval_shape(lambda: model.cache_zeros(
            len(job["prompts"]), serve["s_max"]))
        cache = jax.tree.map(lambda s, sh: jax.ShapeDtypeStruct(
            s.shape, s.dtype, sharding=sh), cache, cache_shardings(cache))
        out[k + "/blocks"] = np.asarray(json.dumps(
            {"params": blocks(model.abstract_params()),
             "cache": blocks(cache)}))
np.savez(out_path, **out)
print("OK")
'''


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's tiny ops: the CPU ``index_add_``
    of the ``'sort'`` region takes ~1,000x longer on eight threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results, one subprocess of 8 fake devices a mesh,
    run side by side."""
    tmp = tmp_path_factory.mktemp("ref_partition")

    def run(mesh):
        cases = [c for c in CASES if c[1] == mesh]
        jobs = [{"key": _case(*c), "arch": c[0], "vocab": c[2],
                 "prompts": [p.tolist() for p in _prompts(c[2] or 256)],
                 "padded": _padded(_prompts(c[2] or 256)).tolist()}
                for c in cases]
        name = f"{mesh[0]}x{mesh[1]}"
        np.savez(tmp / f"{name}_weights.npz", **{
            f"{_case(*c)}/w{i}": w.numpy() for c in cases
            for i, w in enumerate(sorted_leaves(_weights(c[0], c[2])))})
        path = tmp / f"{name}.npz"
        argv = ["ref", json.dumps(jobs), json.dumps(mesh), json.dumps(SERVE),
                str(tmp / f"{name}_weights.npz"), str(path)]
        run_with_devices(f"import sys\nsys.argv = {argv!r}\n" + REF, 8,
                         timeout=600)
        return dict(np.load(path))

    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        parts = list(pool.map(run, MESHES))
    return {k: v for part in parts for k, v in part.items()}


def _config(arch, vocab=None):
    tc = tcfg.get_config(arch).reduced()
    return dataclasses.replace(tc, vocab=vocab) if vocab else tc


@functools.lru_cache(maxsize=None)
def _weights(arch, vocab=None):
    """A config's weights, drawn once by the port and handed to the
    reference (a wave writes no weight)."""
    return tbuild(_config(arch, vocab)).init(
        torch.Generator().manual_seed(1), device="cpu")


def _mesh(shape, device="cpu"):
    if device == "meta":
        return make_mesh(shape, ("data", "model"), ["meta"] * math.prod(shape))
    return make_host_mesh(shape[1], devices=["cpu"] * math.prod(shape))


@pytest.fixture(scope="module")
def engine(ref):
    """``engine(arch, mesh, vocab)``: (model, CPU mesh, an engine on the
    case's weights placed on it), made once a case."""
    made = {}

    def get(arch, shape, vocab):
        key = _case(arch, shape, vocab)
        if key not in made:
            model, mesh = tbuild(_config(arch, vocab)), _mesh(shape)
            with sharding_rules(mesh):
                made[key] = model, mesh, ServingEngine(
                    model, _weights(arch, vocab), ServeConfig(**SERVE))
        return made[key]
    return get


@pytest.mark.parametrize("arch,mesh,vocab", CASES,
                         ids=[_case(*c) for c in CASES])
def test_serving_matches_sharded_reference(ref, engine, arch, mesh, vocab):
    """A wave through ``generate_batch`` on the placed weights gives the
    reference's greedy tokens, and the wave's prefill logits lie within
    1e-5 of their max of the reference's jitted prefill."""
    key = _case(arch, mesh, vocab)
    model, tmesh, eng = engine(arch, mesh, vocab)
    assert all(isinstance(t, Sharded) for _, t in tree_items(eng.params))
    prompts = _prompts(vocab or 256)
    with sharding_rules(tmesh):
        got = eng.generate_batch(prompts)
        logits, cache = model.prefill(
            eng.params, {"tokens": torch.from_numpy(_padded(prompts))},
            SERVE["s_max"])
    assert got == json.loads(str(ref[key + "/tokens"]))
    want = ref[key + "/logits"]
    err = float(np.abs(logits.whole().numpy() - want).max())
    assert err <= RTOL * float(np.abs(want).max()), err


def _index_map(t: Sharded):
    return [[list(c), [[s.start, s.stop] for s in t.index(c)]]
            for c in mesh_coords(t.mesh)]


@pytest.mark.parametrize("arch,mesh,vocab", CASES,
                         ids=[_case(*c) for c in CASES])
def test_placement_matches_devices_indices_map(ref, engine, arch, mesh,
                                              vocab):
    """Every placed weight's and cache leaf's blocks, coordinate by
    coordinate, are where JAX's ``devices_indices_map`` puts them, with
    those blocks' shapes; a coordinate's weight bytes are the dry run's
    argument bytes of the weights on a meta mesh of that shape."""
    key = _case(arch, mesh, vocab)
    want = json.loads(str(ref[key + "/blocks"]))
    model, tmesh, eng = engine(arch, mesh, vocab)
    with sharding_rules(tmesh):
        _, cache = model.prefill(eng.params, {"tokens": torch.from_numpy(
            _padded(_prompts(vocab or 256)))}, SERVE["s_max"])
    for tree, name in ((eng.params, "params"),
                       ({"layers": cache["layers"]}, "cache")):
        items = tree_items(tree, sort=True)
        assert [p for p, _ in items] == [p for p in want[name]
                                         if p != "pos"]
        for path, t in items:
            assert _index_map(t) == want[name][path], path
            for c in mesh_coords(tmesh):
                assert tuple(t.blocks[c].shape) == tuple(
                    s.stop - s.start for s in t.index(c)), path
                assert t.blocks[c].device == tmesh.devices[c]
    with sharding_rules(_mesh(mesh, "meta")):
        per_device = dryrun.device_bytes(model.abstract_params())
    for c in mesh_coords(tmesh):
        assert sum(t.blocks[c].numel() * t.blocks[c].element_size()
                   for _, t in tree_items(eng.params)) == per_device


# ---------------------------------------------------------------------------
# The collectives, counted from the shapes
# ---------------------------------------------------------------------------

def _expected(cfg, shape, b, s, s_max, kind):
    """The dense decoder's collectives on a (data, model) mesh, per kind
    (one device's output bytes, ops), from the rules alone: batch on data,
    the sequence on model where it divides; fsdp rows gathered for each
    product (one op a weight, data > 1); q, k and v gathered on their flat
    lanes where those split and the heads do not hold them whole (q in
    prefill only where the heads are not split); a reduce-scatter along the
    sequence (prefill, where it splits) or an all-reduce after each
    row-parallel product; in decode the flash merge's maxima gathered and
    its sums reduced, scattered by heads where they split."""
    data, model = shape
    d, h, kv, hd, ff, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.vocab)
    bl = b // data if b % data == 0 else b
    fsdp = data if d % data == 0 else 1
    split = (lambda n: model if n % model == 0 else 1)
    seq = split(s) if kind == "prefill" else 1
    sl = s // seq
    out = {"all-gather": [0, 0], "all-reduce": [0, 0],
           "reduce-scatter": [0, 0]}

    def add(k, n_bytes, size):
        if size > 1:
            out[k][0] += n_bytes * 4
            out[k][1] += 1

    def reduce(n_elems_whole, size):
        if seq > 1:
            add("reduce-scatter", n_elems_whole // seq, size)
        else:
            add("all-reduce", n_elems_whole, size)

    rows = bl * s                          # a shard's rows, sequence whole
    for _ in range(cfg.n_layers):
        add("all-gather", bl * s * d, seq)                 # before attention
        for lanes in (h * hd, kv * hd, kv * hd, h * hd):   # wq wk wv wo
            add("all-gather", d * lanes // split(lanes), fsdp)
        if kind == "prefill":
            if h % model:
                add("all-gather", rows * h * hd, split(h * hd))
        else:
            add("all-gather", rows * h * hd, split(h * hd))
        for _kv in range(2):
            add("all-gather", rows * kv * hd, split(kv * hd))
        if kind == "decode" and split(s_max) > 1:
            add("all-gather", model * bl * h, model)       # the maxima
            if h % model == 0:
                add("reduce-scatter", bl * h // model * (hd + 1), model)
            else:
                add("all-reduce", bl * h * (hd + 1), model)
        reduce(rows * d, split(h * hd))                    # after wo
        add("all-gather", bl * s * d, seq)                 # before the FFN
        for _w in range(3):
            add("all-gather", d * ff // split(ff), fsdp)
        reduce(rows * d, split(ff))
    add("all-gather", v // split(v) * d, fsdp)             # the embedding
    reduce(rows * d, split(v))
    if kind == "prefill":
        add("all-gather", bl * seq * d, seq)               # the last rows
    add("all-gather", v // split(v) * d, fsdp)             # the unembedding
    add("all-gather", bl * v, split(v))
    return ({k: x[0] for k, x in out.items()},
            {k: x[1] for k, x in out.items()})


def _counted(fn):
    pmesh.reset_collectives()
    res = fn()
    got = pmesh.collectives()
    return res, tuple({k: v for k, v in part.items()
                       if k in ("all-gather", "all-reduce",
                                "reduce-scatter")} for part in got)


COUNT_CASES = [c for c in CASES if c[0] == "qwen2-0.5b"]


@pytest.mark.parametrize("kind", ("prefill", "decode"))
@pytest.mark.parametrize("arch,mesh,vocab", COUNT_CASES,
                         ids=[_case(*c) for c in COUNT_CASES])
def test_collectives_counted_from_shapes(arch, mesh, vocab, kind):
    """A prefill of 4 x 16 tokens and the decode step after it: the
    per-kind counter equals the count derived from the shapes
    (``_expected``) and the count of the same call traced on a meta mesh
    of the same shape. Nothing is moved on meta."""
    model = tbuild(_config(arch, vocab))
    cfg = model.cfg
    weights = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        3, cfg.vocab, CALL).astype(np.int32))
    counts = []
    for device in ("cpu", "meta"):
        pmesh.reset_moved_bytes()
        tp = weights if device == "cpu" else tree_map(
            lambda t: torch.empty_like(t, device="meta"), weights)
        with sharding_rules(_mesh(mesh, device)):
            tp = model.place(tp)
            t = toks.to(device)
            (logits, cache), pre = _counted(
                lambda: model.prefill(tp, {"tokens": t}, SERVE["s_max"]))
            _, dec = _counted(lambda: model.decode_step(tp, cache, t[:, -1:]))
        counts.append(pre if kind == "prefill" else dec)
        if device == "meta":
            assert pmesh.moved_bytes() == 0
    assert counts[0] == counts[1]
    assert counts[0] == _expected(cfg, mesh, CALL[0], CALL[1] if kind ==
                                  "prefill" else 1, SERVE["s_max"], kind)


def test_whole_counts_the_blocks_it_gathers():
    """``Sharded.whole`` assembles the blocks on the first device and counts
    every block but the first coordinate's; a replicated axis counts each
    distinct block once."""
    from repro_torch.parallel.sharding import shard
    mesh = _mesh((2, 4))
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    for spec, moved in ((("data", "model"), 7 * 8 * 4),
                        (("model", None), 3 * 16 * 4), ((None, None), 0)):
        sx = shard(x, spec, mesh)
        pmesh.reset_moved_bytes()
        assert torch.equal(sx.whole(), x)
        assert pmesh.moved_bytes() == moved, spec


def test_sort_region_reads_placed_blocks_without_copies(engine):
    """The ``'sort'`` region computes on the placed expert blocks
    themselves, views of their storages, and coordinates holding one block
    on one device (here every device is the CPU) share one storage."""
    from repro_torch.models import ffn
    model, tmesh, eng = engine("granite-moe-3b-a800m", (2, 4), None)
    seen = []
    orig = ffn._moe_sort_body

    def spy(x, router, wg, *a):
        seen.append(wg.data_ptr())
        return orig(x, router, wg, *a)
    with sharding_rules(tmesh):
        ffn._moe_sort_body = spy
        try:
            eng.generate_batch(_prompts(256)[:2])
        finally:
            ffn._moe_sort_body = orig
    blocks = eng.params["segments"][0]["u0"]["ffn"]["w_gate"].blocks
    spans = {(b.data_ptr(), b.data_ptr() + b.numel() * b.element_size())
             for b in blocks.values()}
    assert len(spans) == 4            # the experts split 4 ways on "model"
    assert seen and all(any(lo <= p < hi for lo, hi in spans) for p in seen)


WHOLE_CASES = [("internvl2-2b", None, (2, 4)),
               ("granite-moe-3b-a800m", "ellpack", (2, 4)),
               ("granite-moe-3b-a800m", "spmm", (2, 4)),
               ("mistral-large-123b", None, (2, 4)),
               ("deepseek-v2-lite-16b", None, (2, 2, 2))]


@pytest.mark.parametrize("arch,dispatch,shape", WHOLE_CASES,
                         ids=[f"{a}|{d or ''}|{len(m)}"
                              for a, d, m in WHOLE_CASES])
def test_partitioned_equals_whole_weights(arch, dispatch, shape):
    """Paths the reference cases do not take, against the same program on
    whole weights under the same rules: internvl2-2b's patch prefix
    (concatenated before the tokens, then cut to the stream's layout),
    ``'ellpack'`` and ``'spmm'`` (each coordinate's own expert blocks,
    K9's plain twin on local planes), mistral's GQA, and a (2, 2, 2) mesh of ``("pod", "data",
    "model")``, whose batch splits over two axes. Prefill and two decode
    steps within 1e-5 of their max."""
    cfg = tcfg.get_config(arch).reduced()
    if dispatch:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(
        3, cfg.vocab, (4, 8)).astype(np.int32))}
    if cfg.n_vision_tokens:
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    mesh = _mesh(shape) if len(shape) == 2 else make_mesh(
        shape, ("pod", "data", "model"), ["cpu"] * math.prod(shape))
    with sharding_rules(mesh):
        runs = []
        for p in (params, model.place(params)):
            logits, cache = model.prefill(p, batch, SERVE["s_max"])
            out = [logits]
            for _ in range(2):
                nxt = logits if isinstance(logits, torch.Tensor) \
                    else logits.whole()
                logits, cache = model.decode_step(
                    p, cache, nxt.argmax(-1, keepdim=True).to(torch.int32))
                out.append(logits)
            runs.append([t if isinstance(t, torch.Tensor) else t.whole()
                         for t in out])
    for got, want in zip(runs[1], runs[0]):
        assert float((got - want).abs().max()) <= RTOL * float(
            want.abs().max())


@pytest.mark.parametrize("layer", ("gelu_mlp", "ring_decode"))
def test_layers_outside_the_decoders_partitioned(layer):
    """Two layers the seven configs do not run, on placed weights under
    (2, 4) rules against their whole forms: the GELU MLP with nonzero
    biases (``b_out`` added once), and the sliding-window ring decode of
    W = 8 slots (2 a shard) at position 11, its token written in slot 3 on
    the shard owning it, the slots' positions whole on every shard."""
    from repro_torch.models import attention, ffn
    from repro_torch.models.params import init_params
    from repro_torch.parallel.sharding import relayout, shard
    cfg = tcfg.get_config("recurrentgemma-9b").reduced()
    mesh = _mesh((2, 4))
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(4, 8 if layer == "gelu_mlp" else 1, cfg.d_model,
                    generator=gen)
    specs = (ffn.gelu_mlp_specs(cfg) if layer == "gelu_mlp"
             else attention.gqa_specs(cfg))
    params = init_params(specs, gen, device="cpu")
    params = {k: torch.randn(v.shape, generator=gen) if k[0] == "b" else v
              for k, v in params.items()}
    with sharding_rules(mesh) as rules:
        placed = place_params(params, specs)
        xs = shard(x, rules.resolve(("batch", None, None), x.shape), mesh)
        if layer == "gelu_mlp":
            want = ffn.gelu_mlp_apply(params, x, torch.float32)
            got = ffn.gelu_mlp_apply_sharded(placed, xs, torch.float32)
        else:
            w, pos = cfg.griffin.window, 11
            kv = [torch.randn(4, w, cfg.n_kv_heads, cfg.head_dim,
                              generator=gen) for _ in range(2)]
            slots = torch.tensor([8, 9, 10, 3, 4, 5, 6, 7], dtype=torch.int32)
            cache = [shard(t, rules.resolve(("batch", "seq_shard", None,
                                             None), t.shape), mesh)
                     for t in kv]
            ring = shard(slots.clone(), (), mesh)
            want, *whole = attention.gqa_decode_ring(
                params, x, cfg, torch.float32, kv[0].clone(), kv[1].clone(),
                slots, pos, pos % w, w)
            got = attention.gqa_decode_sharded(
                placed, xs, cfg, torch.float32, *cache, pos, rules, window=w,
                slot_pos=ring)
            for a, b in zip(cache + [ring], whole + [slots]):
                assert torch.equal(a.whole(), b)
        got = relayout(got, xs.spec).whole()
    assert float((got - want).abs().max()) <= RTOL * float(want.abs().max())


def test_blocks_without_a_partitioned_program_raise(tmp_path, monkeypatch):
    """Under the rules of a mesh of more than one device every config is
    placed, the SSM, RG-LRU, local-attention and encoder-decoder ones
    included: the engine lays its weights out on the mesh and the trainer
    draws them placed. A block kind without a partitioned program (an
    unknown kind) raises, in the loss and in a decode step, rather than
    run whole on the first device."""
    from repro_torch.models import transformer
    from repro_torch.models.params import is_placed
    from repro_torch.runtime import Trainer, TrainerConfig
    with sharding_rules(_mesh((2, 2))):
        for arch in tcfg.ARCHS:
            model = tbuild(_config(arch))
            eng = ServingEngine(model, model.init(
                torch.Generator().manual_seed(1), device="cpu"),
                ServeConfig(**SERVE))
            assert is_placed(eng.params), arch
            trainer = Trainer(model, TrainerConfig(ckpt_dir=str(tmp_path)),
                              device="cpu")
            assert trainer.partitioned(), arch
            assert is_placed(trainer.init_state()[0]), arch
        model = tbuild(_config("qwen2-0.5b"))
        params = model.place(_weights("qwen2-0.5b"))
        tokens = torch.from_numpy(_padded(_prompts(model.cfg.vocab)))
        _, cache = model.prefill(params, {"tokens": tokens}, SERVE["s_max"])
        plan = transformer.segment_plan
        monkeypatch.setattr(transformer, "segment_plan", lambda cfg: [
            (("conv",) * len(unit), reps) for unit, reps in plan(cfg)])
        with pytest.raises(ValueError, match="no partitioned program"):
            model.loss(params, {"tokens": tokens})
        with pytest.raises(ValueError, match="no partitioned program"):
            model.decode_step(params, cache, tokens[:, -1:])
