"""repro_torch's meshes of more than one axis, its GPipe pipeline and its
compressed gradient mean on CPU meshes, against the JAX reference.

The port's mesh is in-process (``repro_torch.parallel``): every shard is a
tensor on a device of the mesh, here the CPU, so nothing here spawns a
process. The reference's own multi-device tests need fake JAX devices in a
subprocess; here the port runs on CPU meshes of several shards and is held
against the reference's single-device results (the distributed SpGEMM
against ``spgemm_coo`` bit for bit, ``ngroups`` included, on
integer-valued operands), against sequential execution (the pipeline,
atol 1e-5), and against the reference's bounds (the compressed mean);
at one shard or stage, against the reference's own ``shard_map`` bit for
bit; and at 8 stages and 8 shards against the reference's ``shard_map``
on 8 fake devices (a subprocess, ``conftest.run_with_devices``; its meshes
built with Auto axes, as jax 0.9's Explicit default refuses the
reference's programs).
"""
import numpy as np
import pytest
from conftest import run_with_devices

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import repro_torch as rt
from repro.compat import shard_map
from repro.core import ell_cols_from_dense, ell_rows_from_dense, spgemm_coo
from repro.optim import compressed_psum_mean as ref_cpm
from repro.parallel.pipeline import pipeline_apply as ref_pipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import compress_int8, compressed_psum_mean, \
    decompress_int8
from repro_torch.parallel import make_mesh, pipeline_apply

SCHEDULES = ("ring", "cstat", "summa")


def _int_sparse(rng, m, n, density, lo=-4, hi=5):
    return (((rng.random((m, n)) < density)
             * rng.integers(lo, hi, (m, n))).astype(np.float32))


def _operands(seed, m, k, n, da, db):
    rng = np.random.default_rng(seed)
    a, b = _int_sparse(rng, m, k, da), _int_sparse(rng, k, n, db)
    ka = max(1, int((a != 0).sum(0).max()))
    kb = max(1, int((b != 0).sum(1).max()))
    ref = (ell_rows_from_dense(jnp.array(a), ka),
           ell_cols_from_dense(jnp.array(b), kb))
    port = (rt.ell_rows_from_dense(a, ka, device="cpu"),
            rt.ell_cols_from_dense(b, kb, device="cpu"))
    return a, b, ref, port


def _bit_identical(got, ref):
    assert got.cap == ref.row.shape[-1], (got.cap, ref.row.shape)
    row, col, val, ng = rt.to_numpy(got)
    np.testing.assert_array_equal(row, np.asarray(ref.row))
    np.testing.assert_array_equal(col, np.asarray(ref.col))
    np.testing.assert_array_equal(val, np.asarray(ref.val))
    np.testing.assert_array_equal(ng, np.asarray(ref.ngroups))


# ---------------------------------------------------------------------------
# Meshes of more than one axis
# ---------------------------------------------------------------------------

def test_axis_groups_of_a_three_axis_mesh():
    """Groups along each axis of a (2, 3, 2) mesh, one a coordinate of the
    other axes in row-major order, against numpy's layout."""
    names = [f"cpu:{i}" for i in range(12)]
    m = make_mesh((2, 3, 2), ("p", "d", "m"), devices=names)
    ids = np.arange(12).reshape(2, 3, 2)
    for i, axis in enumerate(("p", "d", "m")):
        want = np.moveaxis(ids, i, -1).reshape(-1, ids.shape[i])
        got = m.axis_groups(axis)
        assert [[d.index for d in g] for g in got] == want.tolist()
        assert m.axis_devices(axis) == got[0]
    with pytest.raises(ValueError, match="no axis"):
        m.axis_groups("x")


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("axis", ["a", "b"])
def test_two_axis_mesh_matches_single_device(schedule, axis):
    """The sharded SpGEMM on a (2, 4) CPU mesh over either axis (2 or 4
    shards, the other axis replicating) equals the reference's
    single-device ``spgemm_coo`` bit for bit, ``ngroups`` included; the
    warm call and the ``make_dist_plan`` of that axis's size too."""
    a, b, (ea, eb), (ta, tb) = _operands(21, 24, 32, 28, 0.25, 0.25)
    ref = spgemm_coo(ea, eb, out_cap="auto")
    mesh = make_mesh((2, 4), ("a", "b"), devices=["cpu"] * 8)
    got = rt.spgemm(ta, tb, mesh=mesh, axis=axis, schedule=schedule,
                    check=True)
    _bit_identical(got, ref)
    np.testing.assert_allclose(got.to_dense().numpy(), a @ b, atol=1e-4)
    n_dev = mesh.shape[axis]
    dp = rt.make_dist_plan(ta, tb, n_dev=n_dev, schedule=schedule)
    _bit_identical(rt.spgemm(ta, tb, mesh=mesh, axis=axis, dist_plan=dp),
                   ref)
    if schedule != "cstat":           # 'cstat' has no numeric phase
        st = rt.make_structure(ta, tb, n_dev=n_dev, schedules=(schedule,))
        _bit_identical(rt.spgemm(ta, tb, mesh=mesh, axis=axis,
                                 structure=st), ref)


def test_make_host_mesh():
    """``("data", "model")`` of shape (n // mp, mp) over the devices given;
    a model-parallel size that does not divide them raises."""
    m = make_host_mesh(1, devices=["cpu"])
    assert m.shape == {"data": 1, "model": 1}
    m = make_host_mesh(2, devices=["cpu"] * 8)
    assert m.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(3, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh()


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

def _stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _pipe_operands(n_stages, n_micro=6, mb=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return ({"w": (rng.standard_normal((n_stages, d, d)) * 0.3)
             .astype(np.float32),
             "b": (rng.standard_normal((n_stages, d)) * 0.1)
             .astype(np.float32)},
            rng.standard_normal((n_micro, mb, d)).astype(np.float32))


def test_pipeline_matches_sequential():
    """The reference's test on an 8-stage CPU mesh: ``pipeline_apply``
    equals the stages run one after another (atol 1e-5)."""
    params, x = _pipe_operands(8)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ref = torch.from_numpy(x)
    for s in range(8):
        ref = _stage_fn({"w": tp["w"][s], "b": tp["b"][s]}, ref)
    mesh = make_mesh((8,), ("pipe",), devices=["cpu"] * 8)
    out = pipeline_apply(_stage_fn, tp, torch.from_numpy(x), mesh,
                         axis="pipe")
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def test_pipeline_on_a_two_axis_mesh():
    """Over the 'pipe' axis of a (2, 4) mesh: four stages."""
    params, x = _pipe_operands(4, n_micro=3, seed=1)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ref = torch.from_numpy(x)
    for s in range(4):
        ref = _stage_fn({"w": tp["w"][s], "b": tp["b"][s]}, ref)
    mesh = make_mesh((2, 4), ("data", "pipe"), devices=["cpu"] * 8)
    out = pipeline_apply(_stage_fn, tp, torch.from_numpy(x), mesh,
                         axis="pipe")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def test_pipeline_one_stage_matches_reference():
    """At one stage, the port's pipeline against the reference's
    ``shard_map`` pipeline on a one-device mesh (atol 1e-6)."""
    params, x = _pipe_operands(1)
    want = ref_pipeline(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                        {k: jnp.asarray(v) for k, v in params.items()},
                        jnp.asarray(x), jax.make_mesh((1,), ("pipe",)),
                        axis="pipe")
    got = pipeline_apply(_stage_fn,
                         {k: torch.from_numpy(v) for k, v in params.items()},
                         torch.from_numpy(x),
                         make_mesh((1,), ("pipe",), devices=["cpu"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# The compressed gradient mean
# ---------------------------------------------------------------------------

def test_int8_roundtrip_matches_reference():
    """``compress_int8`` / ``decompress_int8`` equal the reference's bit
    for bit, and the round trip errs by at most half a step."""
    from repro.optim import compress_int8 as rq, decompress_int8 as rdq
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    q, s = compress_int8(torch.from_numpy(x))
    rqq, rs = rq(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rqq))
    assert float(s) == float(rs)
    back = decompress_int8(q, s)
    np.testing.assert_array_equal(back.numpy(), np.asarray(rdq(rqq, rs)))
    assert float((back - torch.from_numpy(x)).abs().max()) \
        <= float(s) / 2 + 1e-6


def test_compressed_psum_mean_8_shards():
    """The reference's 8-device test on 8 CPU shards: the mean within 0.02
    of the true mean, each residual within one quantization step, and a
    second round with the residuals fed back."""
    g = np.linspace(-1, 1, 8 * 32).reshape(8, 32).astype(np.float32)
    mesh = make_mesh((8,), ("data",), devices=["cpu"] * 8)
    grads = [{"g": torch.from_numpy(g[d])} for d in range(8)]
    means, errs = compressed_psum_mean(grads, mesh, "data")
    for m in means:
        np.testing.assert_allclose(m["g"].numpy(), g.mean(0), atol=0.02)
        assert torch.equal(m["g"], means[0]["g"])
    assert max(float(e["g"].abs().max()) for e in errs) \
        <= np.abs(g).max() / 127 + 1e-6
    means2, _ = compressed_psum_mean(grads, mesh, "data", error=errs)
    np.testing.assert_allclose(means2[0]["g"].numpy(), g.mean(0), atol=0.02)
    with pytest.raises(ValueError, match="8 shards"):
        compressed_psum_mean(grads[:3], mesh, "data")


def test_compressed_psum_mean_one_shard_matches_reference():
    """At one shard, the port's mean and residual equal the reference's
    ``shard_map`` over a one-device mesh bit for bit, with and without a
    residual fed in."""
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": {"c": rng.standard_normal(16).astype(np.float32)}}
    err = {"a": rng.standard_normal((4, 8)).astype(np.float32) * 1e-3,
           "b": {"c": rng.standard_normal(16).astype(np.float32) * 1e-3}}
    jmesh = jax.make_mesh((1,), ("data",))
    tmesh = make_mesh((1,), ("data",), devices=["cpu"])
    to_t = (lambda t: jax.tree.map(torch.from_numpy, t))
    for e in (None, err):
        def f(g, e_=e):
            return ref_cpm(g, "data", e_ and jax.tree.map(jnp.asarray, e_))
        want_m, want_e = shard_map(f, mesh=jmesh, in_specs=P(),
                                   out_specs=P())(
            jax.tree.map(jnp.asarray, tree))
        got_m, got_e = compressed_psum_mean(
            [to_t(tree)], tmesh, "data",
            error=None if e is None else [to_t(e)])
        for got, want in ((got_m[0], want_m), (got_e[0], want_e)):
            for k in ("a",):
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
            np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                          np.asarray(want["b"]["c"]))


# ---------------------------------------------------------------------------
# 8 stages and 8 shards against the reference's shard_map
# ---------------------------------------------------------------------------

REF_8 = r'''
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.compat import shard_map
from repro.optim import compressed_psum_mean
from repro.parallel.pipeline import pipeline_apply
src, dst = sys.argv[1], sys.argv[2]
inp = np.load(src)
out = {}
def mesh(name):
    return jax.make_mesh((8,), (name,), axis_types=(AxisType.Auto,))
out["pipe"] = np.asarray(pipeline_apply(
    lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
    {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])},
    jnp.asarray(inp["x"]), mesh("pipe"), axis="pipe"))
for tag, feed in (("", False), ("fed_", True)):
    def f(gs, es):
        e = {"g": es[0]} if feed else None
        mean, err = compressed_psum_mean({"g": gs[0]}, "data", e)
        return mean["g"][None], err["g"][None]
    mean, err = shard_map(f, mesh=mesh("data"), in_specs=(P("data"),
                          P("data")), out_specs=(P("data"), P("data")))(
        jnp.asarray(inp["g"]), jnp.asarray(inp["e"]))
    out[tag + "mean"], out[tag + "err"] = np.asarray(mean), np.asarray(err)
np.savez(dst, **out)
print("OK")
'''


@pytest.fixture(scope="module")
def ref_8(tmp_path_factory):
    """The reference's 8-stage pipeline and 8-shard compressed mean (with
    and without residuals fed in) on 8 fake devices, with their inputs."""
    tmp = tmp_path_factory.mktemp("ref_8")
    params, x = _pipe_operands(8)
    rng = np.random.default_rng(9)
    inputs = dict(w=params["w"], b=params["b"], x=x,
                  g=rng.standard_normal((8, 40)).astype(np.float32),
                  e=(rng.standard_normal((8, 40)) * 1e-2).astype(np.float32))
    np.savez(tmp / "in.npz", **inputs)
    argv = ["ref", str(tmp / "in.npz"), str(tmp / "out.npz")]
    run_with_devices(f"import sys\nsys.argv = {argv!r}\n" + REF_8, 8,
                     timeout=300)
    return inputs, dict(np.load(tmp / "out.npz"))


def test_pipeline_8_stages_matches_reference(ref_8):
    """The port's pipeline over 8 CPU stages against the reference's
    ``shard_map`` pipeline over 8 devices (atol 1e-6)."""
    inputs, want = ref_8
    got = pipeline_apply(_stage_fn, {k: torch.from_numpy(inputs[k])
                                     for k in ("w", "b")},
                         torch.from_numpy(inputs["x"]),
                         make_mesh((8,), ("pipe",), devices=["cpu"] * 8),
                         axis="pipe")
    np.testing.assert_allclose(got.numpy(), want["pipe"], atol=1e-6)


@pytest.mark.parametrize("fed", [False, True])
def test_compressed_psum_mean_8_shards_matches_reference(ref_8, fed):
    """Each of 8 CPU shards' mean and residual against the reference's
    ``shard_map`` over 8 devices, bit for bit (the int8 lattices sum
    exactly in int32), with and without a residual fed in."""
    inputs, want = ref_8
    mesh = make_mesh((8,), ("data",), devices=["cpu"] * 8)
    grads = [{"g": torch.from_numpy(inputs["g"][d])} for d in range(8)]
    errs = [{"g": torch.from_numpy(inputs["e"][d])} for d in range(8)] \
        if fed else None
    means, new_e = compressed_psum_mean(grads, mesh, "data", error=errs)
    tag = "fed_" if fed else ""
    for d in range(8):
        np.testing.assert_array_equal(means[d]["g"].numpy(),
                                      want[tag + "mean"][d])
        np.testing.assert_array_equal(new_e[d]["g"].numpy(),
                                      want[tag + "err"][d])
