"""repro_torch's recurrent and encoder-decoder layers (``models/ssm.py``,
``models/rglru.py``, cross-attention, the bidirectional chunked encoder
attention) and their launchers against the JAX reference on the CPU.

The same numpy inputs and parameters (the reference's ``init_params``
carried over by ``params_from_numpy``) go through both packages. The scans
sum in another order than ``jax.lax.associative_scan`` (``linear_scan``'s
doubling passes), so results agree within rounding: float32 within
1e-4·max|·| (the readings are ~1e-6), bfloat16 within 2e-2·max|·| (the two
frameworks round their bfloat16 products and sums at other points). The
scans run over several chunks of the reduced configs' 16 tokens, so the
carried states cross chunk boundaries.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as rcfg
from repro.models import attention as ra
from repro.models import build_model as rbuild
from repro.models import params as rp
from repro.models import rglru as rrg
from repro.models import ssm as rssm
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServingEngine as RefEngine
from repro_torch import configs as tcfg
from repro_torch.core.formats import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as ta
from repro_torch.models import build_model as tbuild
from repro_torch.models import rglru as trg
from repro_torch.models import ssm as tssm
from repro_torch.models.params import tree_leaves
from repro_torch.serve import ServeConfig, ServingEngine

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, dt: str, what: str = ""):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL[dt] * float(np.abs(want).max()), (what, err)


def _pair(a: np.ndarray, dt: str = "float32"):
    return jnp.asarray(a, JDT[dt]), torch.from_numpy(a).to(TDT[dt])


def _params(spec_fn, name: str, seed: int, dt: str = "float32"):
    """A reference spec tree's params (its own init) in both packages, with
    the two configs in ``dt``."""
    rc, tc = rcfg.get_config(name), tcfg.get_config(name)
    rc = dataclasses.replace(rc, param_dtype=dt, compute_dtype=dt)
    tc = dataclasses.replace(tc, param_dtype=dt, compute_dtype=dt)
    tree = rp.init_params(spec_fn(rc), jax.random.PRNGKey(seed), JDT[dt])
    return tree, params_from_numpy(jax.tree.map(np.asarray, tree),
                                   device="cpu"), rc, tc


def _normal(seed: int, *shape, scale: float = 1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# The causal conv and the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,with_state", [(7, False), (7, True), (1, True),
                                          (2, False)])
def test_conv1d_causal_matches_reference(s, with_state):
    """Output and new window, from zeros or a given window, for a chunk, a
    one-token decode and an input shorter than the K - 1 window rows; the
    RG-LRU block runs the same conv."""
    assert trg._conv1d_causal is tssm._conv1d_causal
    k, di = 4, 6
    x, w, b = _normal(1, 2, s, di), _normal(2, k, di), _normal(3, di)
    st = _normal(4, 2, k - 1, di) if with_state else None
    args = [_pair(a) if a is not None else (None, None)
            for a in (x, w, b, st)]
    out, new = rssm._conv1d_causal(*(a[0] for a in args))
    tout, tnew = tssm._conv1d_causal(*(a[1] for a in args))
    _close(tout, out, "float32", "conv out")
    _close(tnew, new, "float32", "conv state")


def test_ssm_scan_chunk_matches_reference():
    """The doubling scan over 37 steps (not a power of two) with a non-zero
    carried-in state: every step's state and the last."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0.2, 1.0, (2, 37, 6, 4)).astype(np.float32)
    bx = rng.standard_normal((2, 37, 6, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    h_all, h_last = rssm._ssm_scan_chunk(*(jnp.asarray(v) for v in
                                           (a, bx, h0)))
    th_all, th_last = tssm._ssm_scan_chunk(*(torch.from_numpy(v) for v in
                                             (a, bx, h0)))
    _close(th_all, h_all, "float32", "h_all")
    _close(th_last, h_last, "float32", "h_last")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mamba_apply_full_and_decode_match_reference(dt):
    """falcon-mamba's mixer over 48 tokens (three 16-token chunks) from given
    conv and SSM states, with ``return_state``; then three decode steps
    continuing from the returned states."""
    tree, p, rc, tc = _params(rssm.mamba_specs, "falcon-mamba-7b-smoke", 6,
                              dt)
    di, st = tc.ssm.expand * tc.d_model, tc.ssm.d_state
    assert tc.ssm.chunk == 16
    x = _normal(7, 2, 51, tc.d_model)
    conv0 = _normal(8, 2, tc.ssm.d_conv - 1, di, scale=0.5)
    h0 = _normal(9, 2, di, st, scale=0.5)
    (jx, tx), (jc, tcv) = _pair(x[:, :48], dt), _pair(conv0, dt)
    jh, th = _pair(h0)
    out, (conv, h) = rssm.mamba_apply_full(tree, jx, rc, JDT[dt], jc, jh,
                                           return_state=True)
    tout, (tconv, tsh) = tssm.mamba_apply_full(p, tx, tc, TDT[dt], tcv, th,
                                               return_state=True)
    assert tout.dtype == TDT[dt] and tsh.dtype == torch.float32
    _close(tout, out, dt, "out")
    _close(tconv, conv, dt, "conv state")
    _close(tsh, h, dt, "ssm state")
    for t in range(48, 51):
        jx1, tx1 = _pair(x[:, t:t + 1], dt)
        out, conv, h = rssm.mamba_decode(tree, jx1, rc, JDT[dt], conv, h)
        tout, tconv, tsh = tssm.mamba_decode(p, tx1, tc, TDT[dt], tconv, tsh)
        _close(tout, out, dt, f"decode {t}")
        _close(tsh, h, dt, f"decode {t} state")
    _close(tconv, conv, dt, "decoded conv state")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rglru_apply_full_and_decode_match_reference(dt):
    """recurrentgemma's RG-LRU over 48 tokens in chunks of 16, from given
    conv and recurrent states, with ``return_state``; then three decode
    steps."""
    tree, p, rc, tc = _params(rrg.rglru_specs, "recurrentgemma-9b-smoke", 10,
                              dt)
    w = trg._width(tc)
    x = _normal(11, 2, 51, tc.d_model)
    conv0 = _normal(12, 2, tc.griffin.conv_width - 1, w, scale=0.5)
    h0 = _normal(13, 2, w, scale=0.5)
    (jx, tx), (jc, tcv) = _pair(x[:, :48], dt), _pair(conv0, dt)
    jh, th = _pair(h0)
    out, (conv, h) = rrg.rglru_apply_full(tree, jx, rc, JDT[dt], jc, jh,
                                          return_state=True, chunk=16)
    tout, (tconv, tsh) = trg.rglru_apply_full(p, tx, tc, TDT[dt], tcv, th,
                                              return_state=True, chunk=16)
    assert tout.dtype == TDT[dt] and tsh.dtype == torch.float32
    _close(tout, out, dt, "out")
    _close(tconv, conv, dt, "conv state")
    _close(tsh, h, dt, "h")
    for t in range(48, 51):
        jx1, tx1 = _pair(x[:, t:t + 1], dt)
        out, conv, h = rrg.rglru_decode(tree, jx1, rc, JDT[dt], conv, h)
        tout, tconv, tsh = trg.rglru_decode(p, tx1, tc, TDT[dt], tconv, tsh)
        _close(tout, out, dt, f"decode {t}")
        _close(tsh, h, dt, f"decode {t} h")


def test_scan_lengths_must_be_whole_chunks():
    """A sequence longer than one chunk must be a whole number of chunks:
    the reference asserts it, the port raises ``ValueError``; one shorter
    than a chunk is its own chunk."""
    tree, p, rc, tc = _params(rssm.mamba_specs, "falcon-mamba-7b-smoke", 14)
    x = _normal(15, 1, 40, tc.d_model)
    with pytest.raises(AssertionError):
        rssm.mamba_apply_full(tree, jnp.asarray(x), rc, jnp.float32)
    with pytest.raises(ValueError, match="whole number"):
        tssm.mamba_apply_full(p, torch.from_numpy(x), tc, torch.float32)
    tree, p, rc, tc = _params(rrg.rglru_specs, "recurrentgemma-9b-smoke", 16)
    with pytest.raises(AssertionError):
        rrg.rglru_apply_full(tree, jnp.asarray(x), rc, jnp.float32,
                             chunk=16)
    with pytest.raises(ValueError, match="whole number"):
        trg.rglru_apply_full(p, torch.from_numpy(x), tc, torch.float32,
                             chunk=16)
    out, _ = trg.rglru_apply_full(p, torch.from_numpy(x[:, :13]), tc,
                                  torch.float32, chunk=16)
    want, _ = rrg.rglru_apply_full(tree, jnp.asarray(x[:, :13]), rc,
                                   jnp.float32, chunk=16)
    _close(out, want, "float32")


# ---------------------------------------------------------------------------
# Attention of the encoder-decoder
# ---------------------------------------------------------------------------

def test_cross_attention_matches_reference():
    """``cross_kv`` over 16 encoder frames and ``cross_apply`` of 5 decoder
    positions over them (no mask)."""
    tree, p, rc, tc = _params(ra.cross_specs, "whisper-medium-smoke", 17)
    enc = _normal(18, 2, tc.encoder_seq, tc.d_model)
    x = _normal(19, 2, 5, tc.d_model)
    k, v = ra.cross_kv(tree, jnp.asarray(enc), rc, jnp.float32)
    tk, tv = ta.cross_kv(p, torch.from_numpy(enc), tc, torch.float32)
    _close(tk, k, "float32", "k")
    _close(tv, v, "float32", "v")
    out = ra.cross_apply(tree, jnp.asarray(x), k, v, rc, jnp.float32)
    tout = ta.cross_apply(p, torch.from_numpy(x), tk, tv, tc, torch.float32)
    _close(tout, out, "float32", "cross_apply")


def test_gqa_full_bidirectional_chunked_matches_reference():
    """The encoder's self-attention at whisper's 1,500 frames (narrow
    widths): past ``CHUNKED_THRESHOLD`` it takes ``_sdpa_chunked`` with no
    causal mask, over key blocks of 500."""
    tree, p, rc, tc = _params(ra.gqa_specs, "whisper-medium-smoke", 20)
    assert ta._pick_chunk(1500, 512) == ra._pick_chunk(1500, 512) == 500
    assert 1500 > ta.CHUNKED_THRESHOLD
    x = _normal(21, 1, 1500, tc.d_model)
    out, _ = jax.jit(lambda t, a: ra.gqa_full(t, a, rc, jnp.float32,
                                              causal=False))(tree,
                                                             jnp.asarray(x))
    tout, _ = ta.gqa_full(p, torch.from_numpy(x), tc, torch.float32,
                          causal=False)
    _close(tout, out, "float32")


# ---------------------------------------------------------------------------
# Serving and the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_generate_batch_matches_reference_recurrent(arch):
    """A wave of four prompts of 5-32 tokens, the longest 32 (two SSM
    chunks; four local-attention windows), greedy through both engines:
    tokens and counters equal."""
    serve = dict(max_batch=4, max_new_tokens=6, s_max=40)
    rm = rbuild(rcfg.get_config(arch + "-smoke"))
    tm = tbuild(tcfg.get_config(arch + "-smoke"))
    params = rm.init(jax.random.PRNGKey(22))
    ref = RefEngine(rm, params, RefServeConfig(**serve))
    eng = ServingEngine(tm, params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"), ServeConfig(**serve))
    rng = np.random.default_rng(23)
    prompts = [rng.integers(3, tm.cfg.vocab, n).astype(np.int32)
               for n in (5, 32, 17, 9)]
    assert eng.generate_batch(prompts) == ref.generate_batch(prompts)
    ws, gs = ref.stats(), eng.stats()
    for key in ("requests", "tokens", "decode_steps"):
        assert gs[key] == ws[key], key


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_launch_serve_smoke_recurrent(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --smoke --device
    cpu`` with three requests."""
    eng = tserve.main(["--arch", arch, "--smoke", "--requests", "3",
                       "--max-new", "4", "--device", "cpu"])
    st = eng.stats()
    assert st["requests"] == 3 and 3 <= st["tokens"] <= 12
    assert "[serve] 3 reqs" in capsys.readouterr().out


def test_launch_train_smoke_audio(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch whisper-medium --smoke
    --device cpu``: the steps run with frames drawn as the reference draws
    them (``default_rng(step).standard_normal((batch, encoder_seq,
    d_model))``), finite losses, parameters on the CPU."""
    out = ttrain.main(["--arch", "whisper-medium", "--smoke", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--log-every", "1",
                       "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    tr = out["trainer"]
    cfg = tr.model.cfg
    assert cfg.family == "audio"
    for step in (0, 1):
        frames = tr._batch(step)["frames"]
        want = np.random.default_rng(step).standard_normal(
            (2, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
        assert frames.dtype == torch.float32 and frames.device.type == "cpu"
        assert np.array_equal(frames.numpy(), want)
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(t.device.type == "cpu" for t in tree_leaves(out["params"]))
    assert "[train] done" in capsys.readouterr().out
