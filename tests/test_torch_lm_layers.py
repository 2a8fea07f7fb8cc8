"""repro_torch's LM layers against the JAX reference on the CPU: the shared
layers (norms, RoPE, embeddings, losses), attention (GQA full, windowed,
with QKV bias, grouped, chunked past ``CHUNKED_THRESHOLD``; cached and ring
decode; MLA full and absorbed decode), the MoE layer's three dispatches,
and the parameter specs of all ten configs (the recurrent and
encoder-decoder layers: ``test_torch_lm_families.py``).

The same numpy inputs and parameters (the reference's ``init_params``
carried over by ``params_from_numpy``) go through both packages. Float32
results agree within 1e-4·max|·|, bfloat16 ones within 2e-2·max|·| (the two
frameworks round their bfloat16 products and sums at other points).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as rcfg
from repro.models import attention as ra
from repro.models import common as rc
from repro.models import ffn as rf
from repro.models import params as rp
from repro.models import transformer as rt
from repro_torch import configs as tcfg
from repro_torch.core.formats import params_from_numpy
from repro_torch.models import attention as ta
from repro_torch.models import common as tc
from repro_torch.models import ffn as tf
from repro_torch.models import params as tp
from repro_torch.models import transformer as tt

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, dt: str):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL[dt] * float(np.abs(want).max()), err


def _pair(a: np.ndarray, dt: str):
    """One numpy array in both packages, in ``dt`` (bfloat16 rounds the
    same way, to nearest even, in both)."""
    return jnp.asarray(a, JDT[dt]), torch.from_numpy(a).to(TDT[dt])


def _params(spec_fn, cfg_name: str, seed: int):
    """A reference spec tree's params (its own init) in both packages."""
    rcfg_ = rcfg.get_config(cfg_name)
    tree = rp.init_params(spec_fn(rcfg_), jax.random.PRNGKey(seed),
                          jnp.float32)
    return tree, params_from_numpy(jax.tree.map(np.asarray, tree),
                                   device="cpu"), tcfg.get_config(cfg_name)


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_norms_match_reference(dt):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = _pair(x, dt), _pair(w, dt), _pair(b, dt)
    got = tc.rmsnorm(tx, tw, 1e-5)
    assert got.dtype == TDT[dt]
    _close(got, rc.rmsnorm(jx, jw, 1e-5), dt)
    _close(tc.layernorm(tx, tw, tb, 1e-5), rc.layernorm(jx, jw, jb, 1e-5), dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rope_matches_reference(dt):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    jx, tx = _pair(x, dt)
    pos = np.arange(3, 10)
    cos, sin = rc.rope_angles(jnp.asarray(pos), 16, 1e6)
    tcos, tsin = tc.rope_angles(torch.from_numpy(pos), 16, 1e6)
    _close(tcos, cos, "float32")
    _close(tsin, sin, "float32")
    _close(tc.apply_rope(tx, tcos, tsin), rc.apply_rope(jx, cos, sin), dt)
    # per-batch (B, S, D/2) angles
    pb = np.stack([pos, pos + 100])
    cos, sin = rc.rope_angles(jnp.asarray(pb), 16, 1e4)
    tcos, tsin = tc.rope_angles(torch.from_numpy(pb), 16, 1e4)
    _close(tc.apply_rope(tx, tcos, tsin), rc.apply_rope(jx, cos, sin), dt)
    _close(tc.sinusoidal_positions(9, 12), rc.sinusoidal_positions(9, 12),
           "float32")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [False, True])
def test_embed_unembed_and_losses_match_reference(dt, tied):
    cfg = dataclasses.replace(rcfg.get_config("qwen2-0.5b-smoke"),
                              tie_embeddings=tied)
    tree = rp.init_params(rc.embed_specs(cfg), jax.random.PRNGKey(3),
                          jnp.float32)
    p = params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")
    assert ("out" in p) == (not tied)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    x = rc.embed_lookup(tree, jnp.asarray(toks), JDT[dt])
    tx = tc.embed_lookup(p, torch.from_numpy(toks), TDT[dt])
    _close(tx, x, dt)
    logits = rc.unembed(tree, x, JDT[dt])
    tlogits = tc.unembed(p, tx, TDT[dt])
    _close(tlogits, logits, dt)
    _close(tc.next_token_loss(tlogits, torch.from_numpy(toks)),
           rc.next_token_loss(logits, jnp.asarray(toks)), dt)
    w = tree["out"] if not tied else tree["tok"].T
    tw = p["out"] if not tied else p["tok"].T
    _close(tc.sharded_softmax_xent(tx, tw.to(TDT[dt]),
                                   torch.from_numpy(toks)),
           rc.sharded_softmax_xent(x, w.astype(JDT[dt]), jnp.asarray(toks)),
           dt)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _gqa(name: str, seed: int, bias: bool):
    tree, p, cfg = _params(ra.gqa_specs, name, seed)
    if bias:                      # the spec inits biases to zero: draw them
        rng = np.random.default_rng(seed)
        for key in ("bq", "bk", "bv"):
            b = rng.standard_normal(tree[key].shape).astype(np.float32)
            tree[key] = jnp.asarray(b)
            p[key] = torch.from_numpy(b)
    return tree, p, rcfg.get_config(name), cfg


@pytest.mark.parametrize("name,window,s", [
    ("qwen2-0.5b-smoke", 0, 12),          # QKV bias, 4 heads over 2 KV
    ("mistral-large-123b-smoke", 5, 12),  # windowed
    ("qwen1.5-110b-smoke", 0, 1040),      # chunked past CHUNKED_THRESHOLD
    ("yi-34b-smoke", 300, 1040)])         # chunked and windowed
def test_gqa_full_matches_reference(name, window, s):
    bias = "qwen" in name
    tree, p, rcf, tcf = _gqa(name, 5, bias)
    assert tcf.qkv_bias == bias and tcf.n_heads // tcf.n_kv_heads == 2
    x = np.random.default_rng(6).standard_normal((2, s, tcf.d_model)) \
        .astype(np.float32)
    out, (k, v) = ra.gqa_full(tree, jnp.asarray(x), rcf, jnp.float32,
                              window=window, return_kv=True)
    tout, (tk, tv) = ta.gqa_full(p, torch.from_numpy(x), tcf, torch.float32,
                                 window=window, return_kv=True)
    _close(tout, out, "float32")
    _close(tk, k, "float32")
    _close(tv, v, "float32")


def test_sdpa_chunked_prime_length_matches_reference():
    """A prime S takes one-token key blocks (``_pick_chunk``), still one
    tensor op per block."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 1031, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 1031, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 1031, 2, 8)).astype(np.float32)
    assert ta._pick_chunk(1031, 512) == ra._pick_chunk(1031, 512) == 1
    args = [(jnp.asarray(a), torch.from_numpy(a)) for a in (q, k, v)]
    want = ra._sdpa_chunked(*(a[0] for a in args), 2, True, 0)
    got = ta._sdpa_chunked(*(a[1] for a in args), 2, True, 0)
    _close(got, want, "float32")


@pytest.mark.parametrize("name", ["qwen2-0.5b-smoke", "granite-moe-3b-a800m-smoke"])
def test_gqa_decode_and_ring_match_reference(name):
    tree, p, rcf, tcf = _gqa(name, 8, "qwen" in name)
    rng = np.random.default_rng(9)
    b, s_max, kv, hd = 2, 16, tcf.n_kv_heads, tcf.head_dim
    x = rng.standard_normal((b, 1, tcf.d_model)).astype(np.float32)
    ck = rng.standard_normal((b, s_max, kv, hd)).astype(np.float32)
    cv = rng.standard_normal((b, s_max, kv, hd)).astype(np.float32)
    for window in (0, 4):
        out, k2, v2 = ra.gqa_decode(tree, jnp.asarray(x), rcf, jnp.float32,
                                    jnp.asarray(ck), jnp.asarray(cv),
                                    jnp.asarray(6, jnp.int32), window)
        tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        tout, tk2, tv2 = ta.gqa_decode(p, torch.from_numpy(x), tcf,
                                       torch.float32, tk, tv, 6, window)
        assert tk2 is tk                       # written in place
        _close(tout, out, "float32")
        _close(tk2, k2, "float32")
        _close(tv2, v2, "float32")
    # ring buffer of 8 slots holding positions 3..10, decoding position 11
    w = 8
    slot_pos = np.roll(np.arange(3, 11, dtype=np.int32), 3)
    rk, rv = ck[:, :w], cv[:, :w]
    out, k2, v2 = ra.gqa_decode_ring(tree, jnp.asarray(x), rcf, jnp.float32,
                                     jnp.asarray(rk), jnp.asarray(rv),
                                     jnp.asarray(slot_pos),
                                     jnp.asarray(11, jnp.int32), 11 % w, w)
    tsp = torch.from_numpy(slot_pos.copy())
    tout, tk2, tv2 = ta.gqa_decode_ring(
        p, torch.from_numpy(x), tcf, torch.float32,
        torch.from_numpy(rk.copy()), torch.from_numpy(rv.copy()), tsp, 11,
        11 % w, w)
    _close(tout, out, "float32")
    _close(tk2, k2, "float32")
    assert int(tsp[11 % w]) == 11


def test_mla_full_and_decode_match_reference():
    tree, p, tcf = _params(ra.mla_specs, "deepseek-v2-lite-16b-smoke", 10)
    rcf = rcfg.get_config("deepseek-v2-lite-16b-smoke")
    rng = np.random.default_rng(11)
    m = tcf.mla
    x = rng.standard_normal((2, 12, tcf.d_model)).astype(np.float32)
    out, (lat, kr) = ra.mla_full(tree, jnp.asarray(x), rcf, jnp.float32,
                                 return_kv=True)
    tout, (tlat, tkr) = ta.mla_full(p, torch.from_numpy(x), tcf,
                                    torch.float32, return_kv=True)
    _close(tout, out, "float32")
    _close(tlat, lat, "float32")
    _close(tkr, kr, "float32")
    cl = rng.standard_normal((2, 16, m.kv_lora_rank)).astype(np.float32)
    ckr = rng.standard_normal((2, 16, m.rope_head_dim)).astype(np.float32)
    x1 = x[:, :1]
    out, cl2, ckr2 = ra.mla_decode(tree, jnp.asarray(x1), rcf, jnp.float32,
                                   jnp.asarray(cl), jnp.asarray(ckr),
                                   jnp.asarray(9, jnp.int32))
    tout, tcl2, tckr2 = ta.mla_decode(p, torch.from_numpy(x1), tcf,
                                      torch.float32,
                                      torch.from_numpy(cl.copy()),
                                      torch.from_numpy(ckr.copy()), 9)
    _close(tout, out, "float32")
    _close(tcl2, cl2, "float32")
    _close(tckr2, ckr2, "float32")


# ---------------------------------------------------------------------------
# MoE: the three dispatches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("dispatch", ["ellpack", "sort", "spmm"])
@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b-smoke",
                                  "granite-moe-3b-a800m-smoke"])
def test_moe_apply_dispatches_match_reference(name, dispatch, dt):
    r0, t0 = rcfg.get_config(name), tcfg.get_config(name)
    rcf = dataclasses.replace(r0, moe=dataclasses.replace(
        r0.moe, dispatch=dispatch))
    tcf = dataclasses.replace(t0, moe=dataclasses.replace(
        t0.moe, dispatch=dispatch))
    tree = rp.init_params(rf.moe_specs(rcf), jax.random.PRNGKey(12),
                          jnp.float32)
    p = params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")
    x = np.random.default_rng(13).standard_normal((2, 24, tcf.d_model)) \
        .astype(np.float32)
    jx, tx = _pair(x, dt)
    y, aux = rf.moe_apply(tree, jx, rcf, JDT[dt])
    ty, taux = tf.moe_apply(p, tx, tcf, TDT[dt])
    assert ty.dtype == TDT[dt]
    _close(ty, y, dt)
    _close(taux, aux, "float32")


# ---------------------------------------------------------------------------
# params: spec trees of all ten configs
# ---------------------------------------------------------------------------

def _flat(tree, path=()):
    """(path, shape, axes, init, scale) of every Spec, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flat(v, path + (i,))]
    return [(path, tuple(tree.shape), tuple(tree.axes), tree.init,
             tree.scale)]


@pytest.mark.parametrize("name", sorted(rcfg.ARCHS))
def test_decoder_specs_match_reference(name):
    """Full-size spec trees (shapes, logical axes, init kinds, scales) and
    counts equal the reference's, with no allocation, for all ten configs
    (whisper's two stacks included)."""
    from repro.models import build_model as rbuild
    from repro_torch.models import build_model as tbuild
    rm, tm = rbuild(rcfg.ARCHS[name]), tbuild(tcfg.ARCHS[name])
    assert _flat(tm.specs()) == _flat(rm.specs())
    assert tm.n_params() == rm.n_params()
    meta = tm.abstract_params()
    leaves = tp.tree_leaves(meta)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == rm.n_params()
    assert {t.dtype for t in leaves} == {tp.torch_dtype(
        tcfg.ARCHS[name].param_dtype)}


def test_init_params_kinds_and_scales():
    """Zeros, ones and normals times ``fan_in ** -0.5`` of the whole shape
    (stack dim included, as the reference computes it), in the asked dtype;
    a stacked leaf is drawn a slice at a time from one generator, so a seed
    fixes every weight."""
    specs = {"z": tp.Spec((3, 4), (None, None), init="zeros"),
             "o": tp.Spec((5,), (None,), init="ones"),
             "n": tp.stack({"w": tp.Spec((64, 96), (None, None))}, 4),
             "s": tp.Spec((256, 32), (None, None), scale=0.5)}
    a = tp.init_params(specs, torch.Generator().manual_seed(1),
                       torch.bfloat16, "cpu")
    b = tp.init_params(specs, torch.Generator().manual_seed(1),
                       torch.bfloat16, "cpu")
    assert torch.equal(a["n"]["w"], b["n"]["w"])
    assert a["z"].dtype == torch.bfloat16 and not a["z"].any()
    assert bool((a["o"] == 1).all())
    w = a["n"]["w"].float()
    assert w.shape == (4, 64, 96)
    assert abs(float(w.std()) - (4 * 64) ** -0.5) < 0.05 * (4 * 64) ** -0.5
    assert not torch.equal(w[0], w[1])
    assert abs(float(a["s"].float().std()) - 0.5) < 0.03
    assert tp.count_params(specs) == 12 + 5 + 4 * 64 * 96 + 256 * 32
    assert tp.count_params(specs) == rp.count_params(
        jax.tree.map(lambda s: rp.Spec(s.shape, s.axes, s.init, s.scale),
                     specs, is_leaf=tp.is_spec))


def test_block_kinds_not_ported_raise():
    """The block kinds ``mamba`` and ``rec``, once refused, now build: their
    spec trees at full width equal the reference's, and so do the segment
    plans that use them (falcon-mamba's 64 ``mamba`` blocks,
    recurrentgemma's ``(rec, rec, local) × 12, (rec, rec)``)."""
    for kind, name in (("mamba", "falcon-mamba-7b"),
                       ("rec", "recurrentgemma-9b")):
        assert _flat(tt.block_specs(tcfg.ARCHS[name], kind)) == \
            _flat(rt.block_specs(rcfg.ARCHS[name], kind))
        assert tt.segment_plan(tcfg.ARCHS[name]) == \
            rt.segment_plan(rcfg.ARCHS[name])
    assert tt.segment_plan(tcfg.ARCHS["recurrentgemma-9b"]) == [
        (("rec", "rec", "local"), 12), (("rec", "rec"), 1)]
