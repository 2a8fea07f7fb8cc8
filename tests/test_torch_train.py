"""repro_torch's training half against the JAX reference on the CPU:
AdamW, the synthetic data, checkpoints, the fault wrappers, the trainer
and the training launcher.

The same numpy inputs go through both packages in one process. AdamW is
held leaf by leaf over three steps (params, both moments, the step, the
grad norm and the learning rate) to ``ADAMW_RTOL``·max|·| in float32 (the
two differ in the grad norm's summation order, ~1 ulp) and to one bfloat16
rounding in bfloat16; the data batches are equal; checkpoints cross both
ways in float32, bit for bit; the port's ``Trainer`` from the reference's
float32 weights (``init_state`` overridden in both) logs losses within
``LOSS_RTOL`` of the reference's over five steps of reduced qwen2-0.5b.
The reference's own trainer tests (loss drop, resume) are mirrored.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.checkpoint import CheckpointManager as RefCkpt
from repro.configs import get_config as rget
from repro.data import DataConfig as RDataConfig
from repro.data import SyntheticLMDataset as RDataset
from repro.models import build_model as rbuild
from repro.optim import AdamWConfig as RAdamW
from repro.optim import adamw_init as radamw_init
from repro.optim import adamw_update as radamw_update
from repro.runtime import Trainer as RTrainer
from repro.runtime import TrainerConfig as RTrainerConfig
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.formats import params_from_numpy
from repro_torch.data import DataConfig, SyntheticLMDataset, make_host_loader
from repro_torch.launch import train as tlaunch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.models.params import sorted_leaves, tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, PartialUpdateError, adamw_init, \
    adamw_update, global_norm
from repro_torch.optim import adamw as adamw_mod
from repro_torch.runtime import FaultTolerantStep, StragglerDetector, \
    Trainer, TrainerConfig, retry_with_backoff

ADAMW_RTOL = 1e-6
LOSS_RTOL = 1e-4
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.detach().float().numpy()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dt):
    """Three steps on a tree of 1-D, 2-D and stacked 3-D leaves (no decay
    on the 1-D one; the 3-D one updated a slice at a time)."""
    rng = np.random.default_rng(0)
    shapes = {"w": (4, 6), "b": (6,), "s": {"t": (2, 3, 4)}}
    mk = (lambda f: {"w": f(shapes["w"]), "b": f(shapes["b"]),
                     "s": {"t": f(shapes["s"]["t"])}})
    p0 = mk(lambda s: rng.standard_normal(s).astype(np.float32))
    gs = [mk(lambda s: 3 * rng.standard_normal(s).astype(np.float32))
          for _ in range(3)]
    to_j = (lambda t: jax.tree.map(lambda a: jnp.asarray(a, JDT[dt]), t))
    to_t = (lambda t: jax.tree.map(
        lambda a: torch.from_numpy(a).to(TDT[dt]), t))
    rp, tp = to_j(p0), to_t(p0)
    rs, ts = radamw_init(rp), adamw_init(tp)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    for g in gs:
        rp, rs, rm = radamw_update(rp, to_j(g), rs, RAdamW(**cfg))
        tp, ts, tm = adamw_update(tp, to_t(g), ts, AdamWConfig(**cfg))
        for k in ("grad_norm", "lr"):
            assert tm[k].dtype == torch.float32
            assert abs(float(tm[k]) - float(rm[k])) \
                <= ADAMW_RTOL * abs(float(rm[k]))
        assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
        assert int(ts["step"]) == int(rs["step"])
        for tree_t, tree_r, tol in (
                (tp, rp, 2.0 ** -8 if dt == "bfloat16" else ADAMW_RTOL),
                (ts["mu"], rs["mu"], ADAMW_RTOL),
                (ts["nu"], rs["nu"], ADAMW_RTOL)):
            for got, want in zip(jax.tree.leaves(tree_t,
                                                 is_leaf=torch.is_tensor),
                                 jax.tree.leaves(tree_r)):
                assert got.dtype == (TDT[dt] if tree_t is tp
                                     else torch.float32)
                want = _np(want)
                assert float(np.abs(_np(got) - want).max()) \
                    <= tol * float(np.abs(want).max())


def test_adamw_converges_quadratic():
    """The reference's test: 150 steps on sum(w²) drive it below 1e-2."""
    params = {"w": torch.tensor([5.0, -3.0, 2.0], requires_grad=True)}
    state = adamw_init(params)
    cfg = AdamWConfig(lr=0.3, weight_decay=0.0, warmup_steps=1,
                      total_steps=200)
    for _ in range(150):
        (g,) = torch.autograd.grad(torch.sum(torch.square(params["w"])),
                                   params["w"])
        params, state, _ = adamw_update(params, {"w": g}, state, cfg)
    assert float(torch.sum(torch.square(params["w"]))) < 1e-2


def test_adamw_clip_and_schedule():
    """The reference's test: the grad norm before the clip, and the lr a
    tenth of the way through the warmup."""
    params = {"w": torch.ones(4)}
    state = adamw_init(params)
    cfg = AdamWConfig(lr=1.0, clip_norm=0.5, warmup_steps=10)
    _, _, metrics = adamw_update(params, {"w": torch.full((4,), 100.0)},
                                 state, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert float(metrics["lr"]) == pytest.approx(0.1, rel=1e-3)
    assert float(global_norm({"a": torch.ones(2, 3, 4)})) \
        == pytest.approx(24 ** 0.5)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,host_id,n_hosts", [(0, 0, 1), (7, 0, 1),
                                                  (3, 1, 2), (11, 3, 4)])
def test_dataset_batches_equal_reference(step, host_id, n_hosts):
    kw = dict(vocab=1000, seq_len=64, global_batch=8, seed=3,
              n_hosts=n_hosts, host_id=host_id)
    got = SyntheticLMDataset(DataConfig(**kw)).batch(step)["tokens"]
    want = RDataset(RDataConfig(**kw)).batch(step)["tokens"]
    assert got.dtype == want.dtype and got.shape == (8 // n_hosts, 64)
    np.testing.assert_array_equal(got, want)


def test_data_prefetcher():
    ds = SyntheticLMDataset(DataConfig(vocab=100, seq_len=16, global_batch=2))
    it = make_host_loader(ds, start_step=3)
    np.testing.assert_array_equal(next(iter(it))["tokens"],
                                  ds.batch(3)["tokens"])
    it.close()


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _trees(rng, dt=np.float32):
    params = {"a": rng.standard_normal((2, 3)).astype(dt),
              "seg": [{"w": rng.standard_normal((2, 4, 3)).astype(dt)},
                      {"w": rng.standard_normal(5).astype(dt)}]}
    opt = {"mu": jax.tree.map(np.zeros_like, params),
           "nu": jax.tree.map(np.ones_like, params),
           "step": np.array(7, np.int32)}
    return params, opt


def test_checkpoint_crosses_packages_float32(tmp_path):
    """A float32 checkpoint of the port restores in the reference and one
    of the reference in the port, every leaf bit for bit; both write the
    same keys, shapes and dtypes."""
    params, opt = _trees(np.random.default_rng(1))
    t_params = params_from_numpy(params, device="cpu")
    t_opt = params_from_numpy(opt, device="cpu")
    port, ref = CheckpointManager(tmp_path / "port"), RefCkpt(tmp_path / "ref")
    port.save(3, t_params, t_opt, extra={"next_step": 3})
    ref.save(3, jax.tree.map(jnp.asarray, params),
             jax.tree.map(jnp.asarray, opt), extra={"next_step": 3})
    mans = [json.loads((tmp_path / d / "step_00000003" / "manifest.json")
                       .read_text()) for d in ("port", "ref")]
    assert mans[0]["leaves"] == mans[1]["leaves"]
    rp, ro, extra = RefCkpt(tmp_path / "port").restore(
        3, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, opt))
    assert extra == {"next_step": 3}
    for got, want in zip(jax.tree.leaves((rp, ro)),
                         jax.tree.leaves((params, opt))):
        np.testing.assert_array_equal(np.asarray(got), want)
    tp, to, extra = CheckpointManager(tmp_path / "ref").restore(
        3, t_params, t_opt, device="cpu")
    assert extra == {"next_step": 3}
    for got, want in zip(tree_leaves((tp, to)), tree_leaves((t_params, t_opt))):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_checkpoint_bfloat16_bits(tmp_path):
    """bfloat16 leaves are stored as their raw 16-bit records with dtype
    'bfloat16' in the manifest and read back bit for bit; the reference's
    bfloat16 checkpoint reads back in the port bit for bit too."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 5, generator=g).bfloat16(),
              "b": torch.randn(4, generator=g).bfloat16()}
    opt = {"step": torch.tensor(2, dtype=torch.int32)}
    mgr = CheckpointManager(tmp_path / "port", keep_n=1)
    mgr.save(4, params, opt)
    man = json.loads((tmp_path / "port" / "step_00000004" / "manifest.json")
                     .read_text())
    assert man["leaves"]["params/w"] == {"shape": [3, 5],
                                         "dtype": "bfloat16"}
    like = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, o2, _ = mgr.restore(4, like, {"step": torch.zeros((), dtype=torch.int32)},
                            device="cpu")
    for k in params:
        assert p2[k].dtype == torch.bfloat16
        assert torch.equal(p2[k].view(torch.int16), params[k].view(torch.int16))
    assert int(o2["step"]) == 2
    ref = RefCkpt(tmp_path / "ref")
    ref.save(1, {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
                 for k, v in params.items()},
             {"step": jnp.asarray(2, jnp.int32)})
    p3, _, _ = CheckpointManager(tmp_path / "ref").restore(
        1, like, {"step": torch.zeros((), dtype=torch.int32)}, device="cpu")
    for k in params:
        assert torch.equal(p3[k].view(torch.int16), params[k].view(torch.int16))


def test_checkpoint_keep_n_and_partial_writes(tmp_path):
    """The reference's two tests: ``keep_n`` keeps the newest steps, and a
    stray ``.tmp`` directory or one without a manifest is ignored."""
    mgr = CheckpointManager(tmp_path, keep_n=2)
    params = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}}
    opt = {"mu": {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(4)}},
           "step": torch.tensor(7, dtype=torch.int32)}
    for step in (10, 20, 30):
        mgr.save(step, params, opt, extra={"next_step": step})
    assert mgr.all_steps() == [20, 30]
    p2, o2, extra = mgr.restore(30, params, opt, device="cpu")
    assert torch.equal(p2["a"], params["a"]) and int(o2["step"]) == 7
    assert extra["next_step"] == 30
    (tmp_path / "step_00000099.tmp").mkdir()
    (tmp_path / "step_00000077").mkdir()
    assert mgr.latest_step() == 30


# ---------------------------------------------------------------------------
# Fault tolerance
# ---------------------------------------------------------------------------

def test_straggler_detector_flags_outliers():
    det = StragglerDetector(window=32, k_sigma=4.0, persistent=3)
    for _ in range(20):
        det.record(0.1)
    assert not det.is_straggler
    for _ in range(3):
        det.record(1.5)
    assert det.is_straggler


def test_retry_with_backoff_recovers_and_gives_up():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return 42

    assert retry_with_backoff(flaky, base_delay=0.01)() == 42
    assert calls["n"] == 3

    def always_fails():
        raise RuntimeError("CUDA error: an illegal memory access")

    with pytest.raises(RuntimeError, match="illegal memory"):
        retry_with_backoff(always_fails, max_retries=2, base_delay=0.01)()


class _FailingOnce:
    """A model whose loss raises once, in the forward, before any update."""

    def __init__(self, model, failures: int = 1):
        self.model, self.cfg, self.left = model, model.cfg, failures

    def specs(self):
        return self.model.specs()

    def loss(self, params, batch):
        if self.left:
            self.left -= 1
            raise RuntimeError("transient device fault")
        return self.model.loss(params, batch)


def _small_state(cfg):
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    return model, params, adamw_init(params)


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def test_fault_tolerant_step_retries_from_untouched_state():
    """A step that raises leaves params and optimizer state as they were,
    and its retry equals a clean step from the same state bit for bit; a
    step that keeps failing re-raises."""
    cfg = get_config("qwen2-0.5b-smoke")
    model, params, opt = _small_state(cfg)
    batch = {"tokens": torch.from_numpy(SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=2)).batch(0)["tokens"])}
    clean_p, clean_o = _clone(params), _clone(opt)
    want = make_train_step(model, AdamWConfig())(clean_p, clean_o, batch)

    flaky = _FailingOnce(model)
    raw = make_train_step(flaky, AdamWConfig())
    before = _clone((params, opt))
    with pytest.raises(RuntimeError, match="transient"):
        raw(params, opt, batch)
    for got, was in zip(tree_leaves((params, opt)), tree_leaves(before)):
        assert torch.equal(got, was)
    flaky.left = 1
    got = FaultTolerantStep(raw, max_retries=2)(params, opt, batch)
    assert flaky.left == 0
    for g, w in zip(tree_leaves(got[:2]), tree_leaves(want[:2])):
        assert torch.equal(g.detach(), w.detach())
    for k in ("loss", "grad_norm", "lr"):
        assert torch.equal(got[2][k], want[2][k])
    flaky.left = 5
    with pytest.raises(RuntimeError, match="transient"):
        FaultTolerantStep(raw, max_retries=1)(params, opt, batch)


def test_fault_tolerant_step_does_not_retry_a_partial_update(monkeypatch):
    """A failure planted inside the AdamW update, after two leaves were
    written in place, is raised as ``PartialUpdateError`` (not a
    ``RuntimeError``) and never retried from the half-updated state; the
    step counter has not moved."""
    cfg = get_config("qwen2-0.5b-smoke")
    model, params, opt = _small_state(cfg)
    batch = {"tokens": torch.from_numpy(SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=2)).batch(0)["tokens"])}
    real = adamw_mod._update_leaf
    calls = {"n": 0}

    def fails_third(*args):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("CUDA error: out of memory")
        return real(*args)

    monkeypatch.setattr(adamw_mod, "_update_leaf", fails_third)
    before = _clone(params)
    raw = make_train_step(model, AdamWConfig(lr=1e-2, warmup_steps=1))
    with pytest.raises(PartialUpdateError) as info:
        FaultTolerantStep(raw, max_retries=3)(params, opt, batch)
    assert not isinstance(info.value, RuntimeError)
    assert isinstance(info.value.__cause__, RuntimeError)
    assert calls["n"] == 3, "the half-updated step was retried"
    assert int(opt["step"]) == 0
    changed = [not torch.equal(a.detach(), b)
               for a, b in zip(sorted_leaves(params), sorted_leaves(before))]
    assert changed[:2] == [True, True] and not any(changed[2:])


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's trainer on reduced qwen2-0.5b, five steps from its
    own weights, each logged; the weights returned to carry over."""
    cfg = rget("qwen2-0.5b").reduced()
    model = rbuild(cfg)
    rp = model.init(jax.random.PRNGKey(4))
    weights = jax.tree.map(np.asarray, rp)
    tcfg = RTrainerConfig(steps=5, log_every=1, ckpt_every=100,
                          ckpt_dir=str(tmp_path_factory.mktemp("ref")),
                          global_batch=4, seq_len=32)
    tr = RTrainer(model, tcfg, RAdamW(lr=1e-3, warmup_steps=2))
    tr.init_state = lambda rng=None: (jax.tree.map(jnp.asarray, weights),
                                      radamw_init(jax.tree.map(jnp.asarray,
                                                               weights)))
    return weights, tr.run(resume=False)["history"]


def test_trainer_matches_reference_from_carried_weights(reference_run,
                                                        tmp_path):
    """The port's ``Trainer`` from the reference's float32 weights: the
    same steps logged, each loss within ``LOSS_RTOL``."""
    weights, ref_hist = reference_run
    model = build_model(get_config("qwen2-0.5b-smoke"))
    tcfg = TrainerConfig(steps=5, log_every=1, ckpt_every=100,
                         ckpt_dir=str(tmp_path), global_batch=4, seq_len=32)
    tr = Trainer(model, tcfg, AdamWConfig(lr=1e-3, warmup_steps=2),
                 device="cpu")

    def carried(generator=None):
        p = params_from_numpy(weights, device="cpu")
        return p, adamw_init(p)
    tr.init_state = carried
    hist = tr.run(resume=False)["history"]
    assert [h["step"] for h in hist] == [h["step"] for h in ref_hist]
    for got, want in zip(hist, ref_hist):
        assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(
            want["loss"]), (got, want)
        assert np.isfinite(got["grad_norm"]) and got["ms"] > 0


def test_training_reduces_loss(tmp_path):
    """The reference's test on the port: 30 steps of reduced qwen2-0.5b
    lower the loss by more than 0.2."""
    model = build_model(get_config("qwen2-0.5b").reduced())
    tcfg = TrainerConfig(steps=30, log_every=5, ckpt_every=100,
                         ckpt_dir=str(tmp_path), global_batch=8, seq_len=64)
    out = Trainer(model, tcfg, AdamWConfig(lr=3e-3, warmup_steps=5),
                  device="cpu").run(resume=False)
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0] - 0.2, losses


def test_checkpoint_resume_continues(tmp_path):
    """The reference's test on the port: a run extended from 10 to 14
    steps resumes at step 10, from leaves equal to the saved ones."""
    model = build_model(get_config("qwen2-0.5b").reduced())
    t1 = TrainerConfig(steps=10, log_every=2, ckpt_every=10,
                       ckpt_dir=str(tmp_path), global_batch=4, seq_len=32)
    first = Trainer(model, t1, AdamWConfig(lr=1e-3), device="cpu").run(
        resume=False)
    t2 = dataclasses.replace(t1, steps=14)
    trainer = Trainer(model, t2, AdamWConfig(lr=1e-3), device="cpu")
    p, o = trainer.init_state()
    rp, ro, extra = trainer.ckpt.restore(10, p, o, device="cpu")
    assert extra == {"next_step": 10}
    for got, want in zip(tree_leaves((rp, ro)),
                         tree_leaves((first["params"], first["opt_state"]))):
        assert torch.equal(got, want.detach())
    out = trainer.run(resume=True)
    steps = [h["step"] for h in out["history"]]
    assert min(steps) >= 10, f"should resume at step 10, got {steps}"


def test_launch_train_smoke(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch qwen2-0.5b --smoke`` on
    the CPU (a (1, 1) mesh); ``--model-parallel 2`` trains on four CPU
    devices, and a size that does not divide the devices raises
    ``ValueError``, as the reference's ``assert`` does."""
    out = tlaunch.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "3",
                        "--batch", "2", "--seq", "16", "--log-every", "1",
                        "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                        "--device", "cpu"])
    assert [h["step"] for h in out["history"]] == [0, 1, 2]
    assert out["trainer"].ckpt.all_steps() == [2]
    text = capsys.readouterr().out
    assert "device=cpu" in text and "[train] done" in text
    assert out["trainer"].device == torch.device("cpu")
    assert all(p.device.type == "cpu"
               for p in tree_leaves(out["params"]))
    assert out["mesh"].shape == {"data": 1, "model": 1}
    out = tlaunch.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "2",
                        "--batch", "2", "--seq", "16", "--model-parallel",
                        "2", "--ckpt-dir", str(tmp_path / "mp"),
                        "--no-resume"], devices=["cpu"] * 4)
    assert out["mesh"].shape == {"data": 2, "model": 2}
    assert [h["step"] for h in out["history"]] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    for mp, n in ((2, 1), (3, 4)):
        with pytest.raises(ValueError, match="does not divide"):
            tlaunch.main(["--arch", "qwen2-0.5b", "--smoke",
                          "--model-parallel", str(mp), "--device", "cpu"],
                         devices=None if n == 1 else ["cpu"] * n)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4), (4, 1)])
def test_launch_train_model_parallel_moe(tmp_path, mesh):
    """``launch.train.main(..., devices=["cpu"] * 4)`` on granite-moe's
    smoke config under ``'sort'``: the trainer runs under the host mesh of
    four devices, so it trains partitioned (the weights placed, each
    step's MoE layers one token group a data shard, their experts split
    over ``"model"``: 8 experts, every model size here divides them), and
    its collectives' copies count in ``moved_bytes``. The first step's
    loss is ``Model.loss`` of the initial weights placed under the same
    mesh."""
    from repro_torch.parallel import mesh as pmesh
    from repro_torch.parallel import sharding_rules
    argv = ["--arch", "granite-moe-3b-a800m", "--smoke", "--steps", "2",
            "--batch", "4", "--seq", "16", "--log-every", "1",
            "--model-parallel", str(mesh[1]), "--ckpt-dir", str(tmp_path),
            "--no-resume"]
    pmesh.reset_moved_bytes()
    out = tlaunch.main(argv, devices=["cpu"] * 4)
    assert out["mesh"].shape == {"data": mesh[0], "model": mesh[1]}
    assert pmesh.moved_bytes() > 0
    hist = out["history"]
    assert [h["step"] for h in hist] == [0, 1]
    trainer = out["trainer"]
    params, _ = trainer.init_state()
    with sharding_rules(out["mesh"]), torch.no_grad():
        want = trainer.model.loss(trainer.model.place(params),
                                  trainer._batch(0)).first().item()
    assert hist[0]["loss"] == want
