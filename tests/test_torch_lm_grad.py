"""repro_torch's differentiable LM loss and K9's backward against the JAX
reference on the CPU, and K10's plain twin in bfloat16.

``Model.loss``'s gradient (autograd through the port's decoder, the MoE
dispatches, K9's ``EllSpmm`` and the activation checkpoints) is held
against ``jax.grad`` of the reference's loss on the reduced configs of
qwen2-0.5b, deepseek-v2-lite-16b (MLA, ``'sort'``), granite-moe-3b
under ``'sort'``, ``'ellpack'`` and ``'spmm'``, falcon-mamba-7b,
recurrentgemma-9b and whisper-medium (with frames), in float32, from the
reference's weights carried over by ``params_from_numpy``: the loss within
1e-5 relative, every leaf's grad within ``GRAD_RTOL``·max|g_ref| + 1e-6
(the two differ in summation order only; they agree to ~2e-6). The three
recurrent and encoder-decoder families run 32 tokens, so the SSM's
gradient crosses a scan-chunk boundary and recurrentgemma's its local
window; the others 12. The reference's jitted grads are computed once a
module (``ref_grads``).

``kernels.ops.ell_spmm``'s backward is held against ``jax.grad`` of the
reference's ``spmm_ell_dense`` bit for bit on integer-valued operands with
dead lanes (every float32 sum exact in any order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as rcfg
from repro.core.formats import EllRows as REllRows
from repro.core.spgemm import spmm_ell_dense
from repro.kernels import nm_spmm as ref_nm
from repro.models import build_model as rbuild
from repro_torch import configs as tcfg
from repro_torch.core.formats import params_from_numpy
from repro_torch.kernels import ell_spmm as tes
from repro_torch.kernels import nm_spmm as tnm
from repro_torch.kernels import ops
from repro_torch.models import build_model as tbuild
from repro_torch.models.params import sorted_leaves, tree_leaves

GRAD_RTOL = 1e-4
CASES = [("qwen2-0.5b", None), ("deepseek-v2-lite-16b", "sort"),
         ("granite-moe-3b-a800m", "sort"), ("granite-moe-3b-a800m", "ellpack"),
         ("granite-moe-3b-a800m", "spmm"), ("falcon-mamba-7b", None),
         ("recurrentgemma-9b", None), ("whisper-medium", None)]
LENGTHS = {"falcon-mamba-7b": 32, "recurrentgemma-9b": 32,
           "whisper-medium": 32}          # the rest: 12


def _configs(arch, dispatch, **over):
    rc, tc = rcfg.get_config(arch + "-smoke"), tcfg.get_config(arch + "-smoke")
    if dispatch:
        rc = dataclasses.replace(rc, moe=dataclasses.replace(
            rc.moe, dispatch=dispatch))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, dispatch=dispatch))
    return dataclasses.replace(rc, **over), dataclasses.replace(tc, **over)


@pytest.fixture(scope="module")
def ref_grads():
    """(loss, grads, weights, batch) of the reference a case, jitted once
    a module; the batch is numpy, "tokens" and, for whisper, "frames"."""
    cache = {}

    def get(arch, dispatch):
        if (arch, dispatch) not in cache:
            rc, _ = _configs(arch, dispatch)
            rm = rbuild(rc)
            rp = rm.init(jax.random.PRNGKey(1))
            rng = np.random.default_rng(2)
            batch = {"tokens": rng.integers(
                0, rc.vocab, (2, LENGTHS.get(arch, 12))).astype(np.int32)}
            if rc.family == "audio":
                batch["frames"] = rng.standard_normal(
                    (2, rc.encoder_seq, rc.d_model)).astype(np.float32)
            loss, g = jax.jit(jax.value_and_grad(rm.loss))(
                rp, {k: jnp.asarray(v) for k, v in batch.items()})
            cache[arch, dispatch] = (float(loss), jax.tree.leaves(g),
                                     jax.tree.map(np.asarray, rp), batch)
        return cache[arch, dispatch]
    return get


def _port_grads(arch, dispatch, weights, batch, **over):
    _, tc = _configs(arch, dispatch, **over)
    tp = params_from_numpy(weights, device="cpu")
    leaves = sorted_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tbuild(tc).loss(tp, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch,dispatch", CASES)
def test_loss_grads_match_reference(ref_grads, arch, dispatch):
    """Every parameter's gradient of ``Model.loss`` against ``jax.grad``
    of the reference's, from the same float32 weights and tokens."""
    rloss, rg, weights, batch = ref_grads(arch, dispatch)
    loss, grads = _port_grads(arch, dispatch, weights, batch)
    assert abs(loss.item() - rloss) <= 1e-5 * abs(rloss)
    assert len(grads) == len(rg)
    for i, (got, want) in enumerate(zip(grads, rg)):
        want = np.asarray(want)
        assert got.shape == want.shape, i
        err = float(np.abs(got.numpy() - want).max())
        assert err <= GRAD_RTOL * float(np.abs(want).max()) + 1e-6, (i, err)
        assert float(np.abs(want).max()) > 0, i      # every leaf is reached


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_remat_changes_no_value(ref_grads, remat):
    """``cfg.remat`` 'none', 'full' (each block checkpointed) and 'dots'
    (matmul outputs saved) give the same loss and grads bit for bit."""
    _, _, weights, batch = ref_grads("granite-moe-3b-a800m", "spmm")
    base = _port_grads("granite-moe-3b-a800m", "spmm", weights, batch,
                       remat="none")
    got = _port_grads("granite-moe-3b-a800m", "spmm", weights, batch,
                      remat=remat)
    assert torch.equal(got[0], base[0])
    for g, w in zip(got[1], base[1]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b",
                                  "whisper-medium"])
def test_remat_changes_no_value_recurrent(ref_grads, arch):
    """The ``mamba`` and ``rec`` blocks and whisper's two stacks under
    ``remat="full"`` (each block or layer checkpointed, its scans and
    attention recomputed in the backward) give the loss and grads of
    ``remat="none"`` bit for bit."""
    _, _, weights, batch = ref_grads(arch, None)
    base = _port_grads(arch, None, weights, batch, remat="none")
    got = _port_grads(arch, None, weights, batch, remat="full")
    assert torch.equal(got[0], base[0])
    for g, w in zip(got[1], base[1]):
        assert torch.equal(g, w)


def test_stacked_leaves_get_one_grad_each():
    """A stacked segment's leaves (qwen2's two layers) are split with
    ``unbind``: each layer's grad lands in its own slice of one grad."""
    cfg = tcfg.get_config("qwen2-0.5b-smoke")
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    wq = params["segments"][0]["u0"]["attn"]["wq"]
    assert wq.shape[0] == cfg.n_layers
    for p in tree_leaves(params):
        p.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    model.loss(params, {"tokens": toks}).backward()
    assert wq.grad.shape == wq.shape
    assert all(float(wq.grad[i].abs().max()) > 0 for i in range(wq.shape[0]))


# ---------------------------------------------------------------------------
# K9's backward
# ---------------------------------------------------------------------------

def _ell_operands(seed, k, n, d, n_rows, dead=0.3):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_rows, (k, n)).astype(np.int32)
    idx[rng.random((k, n)) < dead] = -1
    val = rng.integers(-4, 5, (k, n)).astype(np.float32)
    x = rng.integers(-4, 5, (n, d)).astype(np.float32)
    dy = rng.integers(-4, 5, (n_rows, d)).astype(np.float32)
    return val, idx, x, dy


@pytest.mark.parametrize("k,n,d,n_rows", [(1, 1, 1, 1), (3, 50, 7, 40),
                                          (8, 64, 16, 100), (6, 33, 5, 2)])
def test_ell_spmm_backward_matches_jax_grad(k, n, d, n_rows):
    """dval and dX of ``ops.ell_spmm`` (the ``EllSpmm`` Function) equal
    ``jax.grad`` of ``spmm_ell_dense`` bit for bit on integer operands with
    dead lanes, and so do the plain twin's own autograd gradients; ``idx``
    gets none and the forward equals the plain twin."""
    val, idx, x, dy = _ell_operands(k * n + d, k, n, d, n_rows)

    def f(v, xx):
        y = spmm_ell_dense(REllRows(val=v, idx=jnp.asarray(idx),
                                    n_rows=n_rows), xx)
        return jnp.sum(y * jnp.asarray(dy))
    rdv, rdx = jax.grad(f, argnums=(0, 1))(jnp.asarray(val), jnp.asarray(x))
    tv = torch.from_numpy(val).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ti = torch.from_numpy(idx)
    y = ops.ell_spmm(tv, ti, tx, n_rows)
    assert y.grad_fn is not None and "EllSpmm" in type(y.grad_fn).__name__
    assert torch.equal(y.detach(), tes.ell_spmm_plain(tv.detach(), ti,
                                                      tx.detach(), n_rows))
    gv, gx = torch.autograd.grad(y, (tv, tx), torch.from_numpy(dy))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rdv))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(rdx))
    assert not bool(gv[torch.from_numpy(idx < 0)].any())
    pv, px = torch.autograd.grad(tes.ell_spmm_plain(tv, ti, tx, n_rows),
                                 (tv, tx), torch.from_numpy(dy))
    assert torch.equal(gv, pv) and torch.equal(gx, px)


def test_ell_spmm_backward_bf16_and_partial_grads():
    """In bfloat16 the gradients come back bfloat16, within one bfloat16
    rounding of the float32 gradients of the same (widened) operands; with
    only X requiring grad, dval is not formed."""
    val, idx, x, dy = _ell_operands(7, 4, 40, 6, 30)
    rng = np.random.default_rng(8)
    fval = torch.from_numpy(val * rng.random(val.shape, np.float32))
    fx = torch.from_numpy(x * rng.random(x.shape, np.float32))
    bv = fval.bfloat16().requires_grad_(True)
    bx = fx.bfloat16().requires_grad_(True)
    ti, tdy = torch.from_numpy(idx), torch.from_numpy(dy).bfloat16()
    gv, gx = torch.autograd.grad(ops.ell_spmm(bv, ti, bx, 30), (bv, bx), tdy)
    assert gv.dtype == gx.dtype == torch.bfloat16
    wv = bv.detach().float().requires_grad_(True)
    wx = bx.detach().float().requires_grad_(True)
    fv_, fx_ = torch.autograd.grad(ops.ell_spmm(wv, ti, wx, 30), (wv, wx),
                                   tdy.float())
    for got, want in ((gv, fv_), (gx, fx_)):
        assert float((got.float() - want).abs().max()) \
            <= 2.0 ** -8 * float(want.abs().max())
    only_x = torch.from_numpy(x).requires_grad_(True)
    y = ops.ell_spmm(torch.from_numpy(val), ti, only_x, 30)
    (gx2,) = torch.autograd.grad(y, only_x, torch.from_numpy(dy))
    assert gx2.shape == only_x.shape
    with torch.no_grad():
        assert ops.ell_spmm(torch.from_numpy(val), ti, only_x, 30).grad_fn \
            is None


# ---------------------------------------------------------------------------
# K10's plain twin in bfloat16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,t,d_in,d_out", [(2, 4, 16, 32, 24),
                                              (4, 8, 9, 64, 40)])
def test_nm_spmm_plain_bf16_matches_reference(n, m, t, d_in, d_out):
    """``nm_spmm_plain`` on bfloat16 X and values (float32 sums, bfloat16
    out) equals the reference's ``nm_spmm_xla`` on the same bfloat16
    operands: equal bits on integer-valued ones, within one bfloat16
    rounding on normal ones."""
    rng = np.random.default_rng(t + d_in)
    r = d_in * n // m
    off = rng.integers(0, m, (r, d_out)).astype(np.int8)
    for integer in (True, False):
        if integer:
            x = rng.integers(-4, 5, (t, d_in)).astype(np.float32)
            val = rng.integers(-4, 5, (r, d_out)).astype(np.float32)
        else:
            x = rng.standard_normal((t, d_in)).astype(np.float32)
            val = rng.standard_normal((r, d_out)).astype(np.float32)
        want = ref_nm.nm_spmm_xla(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(val, jnp.bfloat16),
                                  jnp.asarray(off), n=n, m=m)
        assert want.dtype == jnp.bfloat16
        got = tnm.nm_spmm(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(val).bfloat16(),
                          torch.from_numpy(off), n=n, m=m)
        assert got.dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        if integer:
            np.testing.assert_array_equal(got.float().numpy(), want)
        else:
            assert float(np.abs(got.float().numpy() - want).max()) \
                <= 2.0 ** -8 * float(np.abs(want).max())
