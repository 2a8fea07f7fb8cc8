"""repro_torch's decoder (``models.transformer``) and ``Model`` facade
(``models.api``) against the JAX reference on the CPU, for the reduced
configs of all ten archs: the seven attention-based ones, falcon-mamba
(``mamba`` blocks), recurrentgemma (``rec`` and ``local`` blocks) and
whisper (the encoder-decoder, its batch carrying ``frames``).

Weights are the reference's ``Model.init`` carried over by
``params_from_numpy``; tokens are drawn with numpy from a seed. For each
arch: the full forward's logits, the loss, ``Model.prefill`` on the first
half of the prompt and every teacher-forced ``decode_step`` after it, the
cache layouts and the shape stand-ins. The three recurrent and
encoder-decoder families run 64 tokens, prefill on 32: the SSM's scan
crosses its 16-token chunks (two in the prefill, four in the full
forward) and recurrentgemma's local attention its 8-token window; the
others run 12, prefill on 6. Float32 logits agree within 1e-4·max|·|. The bfloat16 case (deepseek's reduced widths in bfloat16)
agrees within 4e-2·max|·|: through two layers, prefill and six decode
steps, the reference does not hold 2e-2 against itself (its jitted and
eager runs of this case differ by up to 2.16e-2·max|·| at decode step 10,
XLA's fusions keeping float32 intermediates the eager ops round), and the
port's logits fall within 2.6e-2·max|·| of its jitted run. The layer tests
(``test_torch_lm_layers.py``) hold bfloat16 to 2e-2·max|·|.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as rcfg
from repro.models import build_model as rbuild
from repro.models import encdec as red
from repro.models import transformer as rt
from repro_torch import configs as tcfg
from repro_torch.core.formats import params_from_numpy
from repro_torch.models import build_model as tbuild
from repro_torch.models import encdec as ted
from repro_torch.models import transformer as tt
from repro_torch.models.params import tree_leaves

ARCHS = ["mistral-large-123b", "qwen1.5-110b", "qwen2-0.5b", "yi-34b",
         "granite-moe-3b-a800m", "deepseek-v2-lite-16b", "internvl2-2b",
         "falcon-mamba-7b", "recurrentgemma-9b", "whisper-medium"]
LENGTHS = {"falcon-mamba-7b": 64, "recurrentgemma-9b": 64,
           "whisper-medium": 64}          # the rest: 12
TOL = {"float32": 1e-4, "bfloat16": 4e-2}


def _close(got, want, dt: str, what: str = ""):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL[dt] * float(np.abs(want).max()), (what, err)


def _leaves(tree):
    """Leaves with dict keys sorted, the order ``jax.tree.leaves`` gives."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _setup(arch: str, dtype: str = "float32", seed: int = 1):
    rc, tc = rcfg.get_config(arch + "-smoke"), tcfg.get_config(arch + "-smoke")
    if dtype != "float32":
        rc = dataclasses.replace(rc, param_dtype=dtype, compute_dtype=dtype)
        tc = dataclasses.replace(tc, param_dtype=dtype, compute_dtype=dtype)
    rm, tm = rbuild(rc), tbuild(tc)
    rp = rm.init(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    return rm, tm, rp, tp


def _batch(cfg, b: int, s: int, seed: int = 2):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch,dt", [(a, "float32") for a in ARCHS]
                         + [("deepseek-v2-lite-16b", "bfloat16")])
def test_prefill_and_decode_match_reference(arch, dt):
    """The full forward, the loss, the prefill's last logits and cache, and
    every teacher-forced decode step's logits, against the reference."""
    rm, tm, rp, tp = _setup(arch, dt)
    cfg = tm.cfg
    b, s = 2, LENGTHS.get(arch, 12)
    jb, tb = _batch(cfg, b, s)
    prefix = tb.get("patches")
    with torch.inference_mode():
        if cfg.family == "audio":
            full = jax.jit(lambda p, f, t: red.decode_full(
                p, t, red.encode(p, f, rm.cfg), rm.cfg)[0])(
                    rp, jb["frames"], jb["tokens"])
            tfull, none = ted.decode_full(
                tp, tb["tokens"], ted.encode(tp, tb["frames"], cfg), cfg)
        else:
            full, _, _ = jax.jit(lambda p, t, pe: rt.decoder_forward(
                p, t, rm.cfg, prefix_embed=pe))(rp, jb["tokens"],
                                                jb.get("patches"))
            tfull, _, none = tt.decoder_forward(tp, tb["tokens"], cfg,
                                                prefix_embed=prefix)
        assert none is None
        _close(tfull, full, dt, "forward")
        _close(tm.loss(tp, tb), jax.jit(rm.loss)(rp, jb), dt, "loss")

        s0 = s // 2
        plen = cfg.n_vision_tokens if cfg.family == "vlm" else 0
        s_max = s + plen + 4
        jpre = dict(jb, tokens=jb["tokens"][:, :s0])
        tpre = dict(tb, tokens=tb["tokens"][:, :s0])
        rlog, rcache = jax.jit(lambda p, bt: rm.prefill(p, bt, s_max))(
            rp, jpre)
        tlog, tcache = tm.prefill(tp, tpre, s_max)
        _close(tlog, rlog, dt, "prefill")
        assert tcache["pos"] == int(rcache["pos"]) == s0 + plen
        for tl, rl in zip(_leaves(tcache["layers"]),
                          jax.tree.leaves(rcache["layers"])):
            _close(tl, rl, dt, "prefill cache")
        step = jax.jit(rm.decode_step)
        for t in range(s0, s):
            rlog, rcache = step(rp, rcache, jb["tokens"][:, t:t + 1])
            tlog, tcache = tm.decode_step(tp, tcache,
                                          tb["tokens"][:, t:t + 1])
            _close(tlog, rlog, dt, f"decode step {t}")
        assert tcache["pos"] == int(rcache["pos"])
        for tl, rl in zip(_leaves(tcache["layers"]),
                          jax.tree.leaves(rcache["layers"])):
            _close(tl, rl, dt, "decoded cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_zeros_and_input_specs_match_reference(arch):
    rm, tm = rbuild(rcfg.get_config(arch)), tbuild(tcfg.get_config(arch))
    small_r = rbuild(rcfg.get_config(arch + "-smoke"))
    small_t = tbuild(tcfg.get_config(arch + "-smoke"))
    want = small_r.cache_zeros(3, 20)
    got = small_t.cache_zeros(3, 20, device="cpu")
    assert got["pos"] == int(want["pos"]) == 0
    wl = jax.tree.leaves(want["layers"])
    gl = _leaves(got["layers"])
    assert [tuple(t.shape) for t in gl] == [tuple(a.shape) for a in wl]
    for t, a in zip(gl, wl):
        assert np.array_equal(t.float().numpy(), np.asarray(a, np.float32))
    for case in rcfg.SHAPES:
        ws = rm.input_specs(case)
        gs = tm.input_specs(case)
        assert set(gs) == set(ws)
        for k, (shape, dtype) in gs.items():
            assert tuple(shape) == ws[k].shape
            assert str(dtype).removeprefix("torch.") == str(ws[k].dtype)


def test_local_block_ring_cache_matches_reference():
    """The windowed block (recurrentgemma's 1-in-3 'local') on its own: the
    prefill's ring layout (prompt longer and shorter than the window) and
    a decode step through the ring."""
    from repro.models import params as rparams
    rc = rcfg.get_config("recurrentgemma-9b-smoke")
    tc = tcfg.get_config("recurrentgemma-9b-smoke")
    tree = rparams.init_params(rt.block_specs(rc, "local"),
                               jax.random.PRNGKey(4), jnp.float32)
    p = params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")
    for s in (13, 5):
        x = np.random.default_rng(s).standard_normal((2, s, tc.d_model)) \
            .astype(np.float32)
        y, _, cache = rt.block_apply_full(tree, jnp.asarray(x), rc, "local",
                                          jnp.float32, True, 24)
        ty, _, tcache = tt.block_apply_full(p, torch.from_numpy(x), tc,
                                            "local", torch.float32, True, 24)
        _close(ty, y, "float32", "local block")
        for key in ("k", "v"):
            _close(tcache[key], cache[key], "float32", f"ring {key}")
        assert np.array_equal(tcache["slot_pos"].numpy(),
                              np.asarray(cache["slot_pos"]))
        x1 = x[:, :1]
        y, cache = rt.block_apply_decode(tree, jnp.asarray(x1), rc, "local",
                                         jnp.float32, cache,
                                         jnp.asarray(s, jnp.int32))
        ty, tcache = tt.block_apply_decode(p, torch.from_numpy(x1), tc,
                                           "local", torch.float32, tcache, s)
        _close(ty, y, "float32", "local decode")
        assert np.array_equal(tcache["slot_pos"].numpy(),
                              np.asarray(cache["slot_pos"]))


def test_model_init_draws_from_the_generator():
    """``Model.init`` draws every weight from the generator it is given, in
    the config's ``param_dtype``, with the reference's count."""
    tm = tbuild(tcfg.get_config("deepseek-v2-lite-16b-smoke"))
    a = tm.init(torch.Generator().manual_seed(3), device="cpu")
    b = tm.init(torch.Generator().manual_seed(3), device="cpu")
    la, lb = tree_leaves(a), tree_leaves(b)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert sum(t.numel() for t in la) == tm.n_params() == rbuild(
        rcfg.get_config("deepseek-v2-lite-16b-smoke")).n_params()
    assert isinstance(a["segments"], list) and len(a["segments"]) == 2
    assert all(t.dtype == torch.float32 for t in la)


def test_model_init_device_decides_alone():
    """``device`` alone decides where ``Model.init`` puts the weights, and
    it defaults to the card: a CPU generator with no ``device`` never
    yields CPU weights (it raises: no card here, or the mismatch where
    there is one), a generator on another device than ``device`` raises
    ``ValueError`` naming both, and a CPU generator with ``device="cpu"``
    draws on the CPU."""
    import types
    tm = tbuild(tcfg.get_config("qwen2-0.5b-smoke"))
    with pytest.raises((RuntimeError, ValueError)):
        tm.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cuda:0.*cpu"):
        tm.init(types.SimpleNamespace(device=torch.device("cuda", 0)),
                device="cpu")
    p = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(p))


def test_audio_family_not_ported():
    """The audio family, once refused, now runs: whisper's two-stack spec
    tree equals the reference's (shapes, axes, inits, count), its cache
    has the reference's layout, and a prefill of 5 tokens over 16 frames
    gives the reference's logits and cross-attention keys and values."""
    rm, tm, rp, tp = _setup("whisper-medium")
    assert set(tm.specs()) == {"embed", "encoder", "enc_ln", "decoder",
                               "dec_ln"}
    assert tm.n_params() == rm.n_params()
    assert [tuple(t.shape) for t in _leaves(tm.abstract_params())] == \
        [tuple(a.shape) for a in jax.tree.leaves(rm.abstract_params())]
    cache = tm.cache_zeros(2, 9, device="cpu")
    assert cache["pos"] == 0
    assert {k: tuple(v.shape) for k, v in cache["layers"].items()} == \
        {k: tuple(v.shape) for k, v in rm.cache_zeros(2, 9)["layers"].items()}
    jb, tb = _batch(tm.cfg, 2, 5)
    rlog, rcache = rm.prefill(rp, jb, 9)
    with torch.inference_mode():
        tlog, tcache = tm.prefill(tp, tb, 9)
    _close(tlog, rlog, "float32", "prefill")
    assert tcache["pos"] == int(rcache["pos"]) == 5
    for key in ("k", "v", "ck", "cv"):
        _close(tcache["layers"][key], rcache["layers"][key], "float32", key)
