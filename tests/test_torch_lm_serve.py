"""repro_torch's token serving (``ServingEngine.generate_batch``) and its
launcher (``python -m repro_torch.launch.serve``) against the JAX reference
on the CPU.

The reference's engine and the port's serve the same numpy prompts (left
padded in one wave, so the shorter prompts see EOS pads, unmasked, in both)
with the reference's ``Model.init`` weights carried over by
``params_from_numpy``: greedy outputs equal token for token and the
engines' counters equal. The prefill and decode logits under those tokens
are held within 1e-4·max|·| by ``test_torch_lm_model.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro import configs as rcfg
from repro.models import build_model as rbuild
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServingEngine as RefEngine
from repro_torch import configs as tcfg
from repro_torch.core.formats import params_from_numpy
from repro_torch.launch import serve as tlaunch
from repro_torch.models import build_model as tbuild
from repro_torch.serve import ServeConfig, ServingEngine

COUNTERS = ("requests", "tokens", "decode_steps", "batch_occupancy")
SERVE = dict(max_batch=4, max_new_tokens=8, s_max=40)


def _prompts(seed: int, n: int, vocab: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, int(rng.integers(3, 20))).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b"])
def test_generate_batch_matches_reference(arch):
    rm = rbuild(rcfg.get_config(arch + "-smoke"))
    tm = tbuild(tcfg.get_config(arch + "-smoke"))
    rp = rm.init(jax.random.PRNGKey(7))
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    ref = RefEngine(rm, rp, RefServeConfig(**SERVE))
    eng = ServingEngine(tm, tp, ServeConfig(**SERVE))
    for wave in (4, 3):                  # a full wave, then a partial one
        prompts = _prompts(wave, wave, rm.cfg.vocab)
        want = ref.generate_batch(prompts)
        got = eng.generate_batch(prompts)
        assert got == want
        assert all(1 <= len(o) <= SERVE["max_new_tokens"] for o in got)
    ws, gs = ref.stats(), eng.stats()
    assert set(gs) == set(ws)
    for key in COUNTERS:
        assert gs[key] == ws[key], key
    for key in ("prefill_s", "decode_s", "queue_s", "compute_s"):
        assert gs[key] > 0


def test_generate_batch_eos_stops_decoding():
    """A request whose last decoded token is EOS leaves the wave; decoding
    stops when none is alive, and every emitted token is counted."""
    class _Count:
        calls = 0

        def prefill(self, params, batch, s_max):
            return torch.eye(8)[[4, 6]], {"pos": 0}

        def decode_step(self, params, cache, tokens):
            self.calls += 1
            nxt = torch.where(tokens[:, 0] == 7, 2, tokens[:, 0] + 1)
            return torch.eye(8)[nxt], cache

    m = _Count()
    eng = ServingEngine(m, {"w": torch.zeros(1)},
                        ServeConfig(max_batch=2, max_new_tokens=8, eos_id=2))
    outs = eng.generate_batch([np.array([3], np.int32),
                               np.array([3, 4], np.int32)])
    assert outs == [[4, 5, 6, 7, 2], [6, 7, 2]]
    assert m.calls == 4 and eng.stats["tokens"] == 8
    assert eng.stats["occupancy_sum"] == (2 + 2 + 1 + 1) / 2


def test_serving_engine_first_token_eos_stops():
    """The port of ``tests/test_substrate.py``'s regression: a request whose
    FIRST sampled token is EOS stops at once — no decode step, the token
    counted."""
    cfg = ServeConfig(max_batch=2, max_new_tokens=8, s_max=16, eos_id=2)
    vocab = 8
    calls = {"decode": 0}

    class _EosModel:
        def prefill(self, params, batch, s_max):
            b = batch["tokens"].shape[0]
            logits = torch.zeros((b, vocab))
            logits[:, cfg.eos_id] = 10.0
            return logits, {"pos": 0}

        def decode_step(self, params, cache, tokens):
            calls["decode"] += 1
            raise AssertionError("no decode step after an all-EOS prefill")

    eng = ServingEngine(_EosModel(), {"w": torch.zeros(1)}, cfg)
    outs = eng.generate_batch([np.array([3, 4], np.int32),
                               np.array([5], np.int32)])
    assert outs == [[cfg.eos_id], [cfg.eos_id]]
    assert eng.stats["tokens"] == 2
    assert calls["decode"] == 0


def test_sampling_uses_the_reference_generator():
    """Non-greedy sampling draws from numpy's generator seeded by
    ``cfg.seed``, as the reference's engine does, so equal logits sample
    equal tokens."""
    logits = np.random.default_rng(3).standard_normal((5, 11)) \
        .astype(np.float32)
    kw = dict(greedy=False, temperature=0.7, seed=4)
    ref = RefEngine(rbuild(rcfg.get_config("qwen2-0.5b-smoke")), None,
                    RefServeConfig(**kw))
    eng = ServingEngine(None, None, ServeConfig(**kw))
    for _ in range(3):
        assert np.array_equal(eng._sample(logits), ref._sample(logits))


def test_launch_serve_smoke(capsys):
    """``python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke`` on
    the CPU with two requests; ``--model-parallel 2`` serves on four CPU
    devices, and a size that does not divide the devices raises
    ``ValueError``."""
    eng = tlaunch.main(["--arch", "qwen2-0.5b", "--smoke", "--requests",
                        "2", "--max-new", "4", "--device", "cpu"])
    st = eng.stats()
    assert st["requests"] == 2 and 2 <= st["tokens"] <= 8
    assert "[serve] 2 reqs" in capsys.readouterr().out
    eng = tlaunch.main(["--arch", "qwen2-0.5b", "--smoke", "--requests",
                        "2", "--max-new", "4", "--model-parallel", "2"],
                       devices=["cpu"] * 4)
    assert eng.stats()["requests"] == 2
    for mp, n in ((2, 1), (3, 4)):
        with pytest.raises(ValueError, match="does not divide"):
            tlaunch.main(["--arch", "qwen2-0.5b", "--smoke",
                          "--model-parallel", str(mp), "--device", "cpu"],
                         devices=None if n == 1 else ["cpu"] * n)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_launch_serve_model_parallel_moe(mesh):
    """``launch.serve.main(..., devices=["cpu"] * 4)`` on deepseek's smoke
    config (``'sort'``, shared experts): the waves run under the host
    mesh, and serve as many tokens as the same weights and prompts do
    through ``generate_batch`` under that mesh by hand; the experts'
    split shows in ``moved_bytes``. As in the reference, a wave whose
    tokens the data axis does not divide fails."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import mesh as pmesh
    from repro_torch.parallel import sharding_rules
    argv = ["--arch", "deepseek-v2-lite-16b", "--smoke", "--requests", "4",
            "--max-new", "4", "--model-parallel", str(mesh[1])]
    pmesh.reset_moved_bytes()
    eng = tlaunch.main(argv, devices=["cpu"] * 4)
    assert pmesh.moved_bytes() > 0
    st = eng.stats()
    assert st["requests"] == 4 and 4 <= st["tokens"] <= 16
    model = tbuild(tcfg.get_config("deepseek-v2-lite-16b-smoke"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, model.cfg.vocab, size=rng.integers(4, 16))
               .astype(np.int32) for _ in range(4)]
    again = ServingEngine(model, params, ServeConfig(max_new_tokens=4))
    with sharding_rules(make_host_mesh(mesh[1], ["cpu"] * 4)):
        again.generate_batch(prompts)
        assert again.stats()["tokens"] == st["tokens"]
        if mesh[0] > 1:     # a wave of 3 decodes 3 tokens: 2 groups fail
            with pytest.raises(ValueError, match="do not split"):
                again.generate_batch(prompts[:3])
