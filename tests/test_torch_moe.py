"""repro_torch's MoE layer (``dispatch='spmm'``), top-k routing and SwiGLU
against the JAX reference on the CPU.

The reference's deepseek-v2-lite config, cut by its own ``reduced()`` (8
experts, top-2, 2 shared experts, d_model 64), with ``dispatch='spmm'``
set by ``dataclasses.replace`` over the config's ``'sort'``. The same numpy
parameters and tokens go through both packages. Routing ids are equal, the
kept (token, slot) mask and capacity slots equal an independent numpy
oracle of the reference's rule (a cumsum in (token, k-slot) order), and y
and the aux loss agree at rtol = atol = 1e-5: float32 sums land in another
order in the two frameworks' matmuls and segment sums.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs import deepseek_v2_lite as ref_ds
from repro.models import ffn as ref_ffn
from repro_torch.configs import deepseek_v2_lite as tds
from repro_torch.core.formats import params_from_numpy
from repro_torch.models import ffn as tffn


def _cfg(pkg_config):
    return dataclasses.replace(
        pkg_config.reduced(),
        moe=dataclasses.replace(pkg_config.reduced().moe, dispatch="spmm"))


def _params(rng, cfg):
    m = cfg.moe
    d, fe, e = cfg.d_model, m.d_ff_expert, m.n_experts

    def lin(*shape):
        return (rng.standard_normal(shape)
                / np.sqrt(shape[-2])).astype(np.float32)

    p = {"router": lin(d, e), "w_gate": lin(e, d, fe), "w_up": lin(e, d, fe),
         "w_down": lin(e, fe, d)}
    if m.n_shared:
        fs = m.n_shared * fe
        p["shared"] = {"w_gate": lin(d, fs), "w_up": lin(d, fs),
                       "w_down": lin(fs, d)}
    return p


def _jnp(p):
    return {k: _jnp(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in p.items()}


def test_config_copy_matches_reference():
    assert dataclasses.asdict(tds.CONFIG) == dataclasses.asdict(ref_ds.CONFIG)
    assert dataclasses.asdict(_cfg(tds.CONFIG)) == \
        dataclasses.asdict(_cfg(ref_ds.CONFIG))
    assert tds.CONFIG.n_params() == ref_ds.CONFIG.n_params()


@pytest.mark.parametrize("k,ties", [(2, False), (6, False), (2, True),
                                    (3, True)])
def test_topk_routing_matches_reference(k, ties):
    rng = np.random.default_rng(k)
    if ties:    # many equal logits: lax.top_k keeps the lower expert first
        logits = rng.integers(0, 3, (2, 40, 16)).astype(np.float32)
    else:
        logits = rng.standard_normal((2, 40, 64)).astype(np.float32)
    w_r, ids_r = ref_ffn._topk_routing(jnp.asarray(logits), k)
    w_t, ids_t = tffn._topk_routing(torch.from_numpy(logits), k)
    assert ids_t.dtype == torch.int32 and w_t.dtype == torch.float32
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_r))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_r), rtol=0,
                               atol=1e-6)


def _kept_oracle(ids, n_experts, cap):
    """The reference's capacity rule in numpy: pairs in (token, k-slot)
    order, each kept while its expert has fewer than ``cap`` earlier kept
    pairs; slot = expert·cap + rank."""
    tg, k = ids.shape
    kept = np.zeros((tg, k), bool)
    slot = np.zeros((tg, k), np.int64)
    seen = np.zeros(n_experts, np.int64)
    for t in range(tg):
        for j in range(k):
            e = ids[t, j]
            if seen[e] < cap:
                kept[t, j] = True
                slot[t, j] = e * cap + seen[e]
            seen[e] += 1
    return kept, slot


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_apply_spmm_matches_reference(capacity_factor):
    cfg_r, cfg_t = (dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, capacity_factor=capacity_factor))
        for c in (_cfg(ref_ds.CONFIG), _cfg(tds.CONFIG)))
    rng = np.random.default_rng(14)
    p = _params(rng, cfg_r)
    x = rng.standard_normal((2, 16, cfg_r.d_model)).astype(np.float32)
    y_r, aux_r = ref_ffn.moe_apply(_jnp(p), jnp.asarray(x), cfg_r,
                                   jnp.float32)
    pt = params_from_numpy(p, device="cpu")
    y_t, aux_t = tffn.moe_apply(pt, torch.from_numpy(x), cfg_t,
                                torch.float32)
    assert y_t.shape == tuple(y_r.shape) and y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_r), rtol=1e-5,
                               atol=1e-5)

    # routing: ids from the reference's own top-k, kept mask and slots
    x_grp = x.reshape(1, 32, -1)
    logits = x_grp @ p["router"]
    _, ids_r = ref_ffn._topk_routing(jnp.asarray(logits), cfg_r.moe.top_k)
    _, ids_t, _, kept_t, slot_t = tffn._spmm_route(torch.from_numpy(logits),
                                                   cfg_t)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_r))
    cap = tffn.moe_capacity(32, cfg_t)
    assert cap == max(1, int(32 * capacity_factor * 2 / 8))
    kept, slot = _kept_oracle(np.asarray(ids_r)[0], 8, cap)
    np.testing.assert_array_equal(kept_t[0].numpy(), kept)
    np.testing.assert_array_equal(
        np.where(kept, slot_t[0].numpy(), -1), np.where(kept, slot, -1))
    if capacity_factor < 1:
        assert not kept.all()              # drops are exercised


def test_moe_planes_are_the_routing_ellpack():
    cfg = _cfg(tds.CONFIG)
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((1, 24, 8))
                              .astype(np.float32))
    w, ids, _, kept, slot = tffn._spmm_route(logits, cfg)
    cap = tffn.moe_capacity(24, cfg)
    disp = tffn.dispatch_planes(kept[0], slot[0], 8 * cap, torch.float32)
    comb = tffn.combine_planes(kept[0], slot[0], w[0], 8 * cap,
                               torch.float32)
    assert disp.val.shape == (2, 24) and disp.n_rows == 8 * cap
    assert comb.val.shape == (1, 8 * cap) and comb.n_rows == 24
    # every kept pair appears once in each plane, at the same slot
    assert int((disp.idx >= 0).sum()) == int((comb.idx >= 0).sum()) \
        == int(kept.sum())
    for t in range(24):
        for j in range(2):
            if kept[0, t, j]:
                s = int(slot[0, t, j])
                assert int(disp.idx[j, t]) == s
                assert int(comb.idx[0, s]) == t
                assert float(comb.val[0, s]) == float(w[0, t, j])


@pytest.mark.parametrize("dispatch", ["ellpack", "sort"])
def test_moe_other_dispatches_raise(dispatch):
    cfg = dataclasses.replace(
        tds.CONFIG.reduced(),
        moe=dataclasses.replace(tds.CONFIG.reduced().moe, dispatch=dispatch))
    p = params_from_numpy(_params(np.random.default_rng(0), cfg),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        tffn.moe_apply(p, torch.zeros((1, 4, cfg.d_model)), cfg,
                       torch.float32)


def test_swiglu_matches_reference():
    rng = np.random.default_rng(2)
    p = {"w_gate": rng.standard_normal((16, 24)).astype(np.float32),
         "w_up": rng.standard_normal((16, 24)).astype(np.float32),
         "w_down": rng.standard_normal((24, 16)).astype(np.float32)}
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    got = tffn.swiglu_apply(params_from_numpy(p, device="cpu"),
                            torch.from_numpy(x), torch.float32)
    want = ref_ffn.swiglu_apply(_jnp(p), jnp.asarray(x), jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
