"""The port's training step on every smoke config (the twin of
``tests/test_models_smoke.py``'s train tests: loss finite and positive,
gradients finite), the remat policies' gradients bit-equal, gradient
accumulation against one batch, a smoke step with ``star_train``, and
the training launcher (``python -m repro_torch.launch.train``). It uses
``test_torch_train``'s helpers.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_train import F32, _batch, _models, _torch_batch  # noqa: E402


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_smoke(arch):
    """Every smoke config: loss finite and positive, every gradient
    finite, in bf16 (its dtype) on the port's own init."""
    cfg = tsmoke(arch)
    params = tlm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(_batch(cfg, np.random.default_rng(0)), cfg.dtype)
    (loss, metrics), grads = steps.value_and_grad(params, cfg, batch)
    assert np.isfinite(float(loss)) and float(loss) > 0
    assert np.isfinite(float(metrics["ce"]))
    leaves = tree_leaves(grads)
    assert leaves
    for g in leaves:
        assert torch.isfinite(g.float()).all(), arch


@pytest.mark.parametrize("arch", ["olmo_1b", "olmoe_1b_7b"])
def test_remat_policies_give_equal_grads(arch):
    """``remat`` none, full and dots: the same gradients, bit for bit."""
    _, _, tcfg, tp = _models(arch)
    batch = _torch_batch(_batch(tcfg, np.random.default_rng(4)))
    runs = [steps.value_and_grad(tp, dataclasses.replace(tcfg, remat=r),
                                 batch) for r in ("none", "full", "dots")]
    for (loss, _), grads in runs[1:]:
        assert torch.equal(loss, runs[0][0][0])
        for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][1])):
            assert torch.equal(a, b)


def test_star_train_smoke_trains():
    """olmo_1b's smoke config trains with ``star_train`` (K3's backward):
    loss finite, every gradient finite, and the loss differs from the
    same step with ``star=None`` (STAR is really on in training)."""
    cfg = dataclasses.replace(tsmoke("olmo_1b"), star_train=True)
    params = tlm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(_batch(cfg, np.random.default_rng(0), s=128),
                         cfg.dtype)
    (loss, _), grads = steps.value_and_grad(params, cfg, batch)
    assert np.isfinite(float(loss)) and float(loss) > 0
    for g in tree_leaves(grads):
        assert torch.isfinite(g.float()).all()
    (dense, _), _ = steps.value_and_grad(
        params, dataclasses.replace(cfg, star=None), batch)
    assert float(loss) != float(dense)


def test_train_accum_equals_one_batch():
    """Two microbatches accumulated in fp32 give the one-batch step's
    update at 2e-5: one AdamW step from identical states."""
    _, _, tcfg, tp = _models("olmo_1b")
    batch = _torch_batch(_batch(tcfg, np.random.default_rng(6), b=4))
    out = []
    for accum in (1, 2):
        cfg = dataclasses.replace(tcfg, train_accum=accum,
                                  accum_dtype=torch.float32)
        params = tree_map(lambda x: x.clone(), tp)
        _, opt_init, _ = steps.make_optimizer(cfg, 1e-3)
        step = steps.make_train_step(cfg, lr=1e-3, warmup=0, total_steps=10)
        p, _, m = step(params, opt_init(params), batch)
        out.append((p, m))
    (p1, m1), (p2, m2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), **F32)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), **F32)
    for a, b in zip(tree_leaves(p2), tree_leaves(p1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)


def test_train_launcher_runs_and_refuses_frontend_stubs(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu``: a smoke
    config trains and checkpoints; the encoder-decoder and embeddings
    archs are refused with the reference launcher's message."""
    out = ttrain.main(["--device", "cpu", "--arch", "olmo_1b", "--steps",
                       "3", "--seq", "32", "--batch", "2", "--ckpt",
                       str(tmp_path)])
    assert out["device"] == "cpu" and [s for s, _ in out["history"]] == [0]
    assert (tmp_path / "step_000000003" / "COMMITTED").exists()
    assert "[train] olmo_1b: loss" in capsys.readouterr().out
    for arch in ("seamless_m4t_large_v2", "internvl2_26b"):
        with pytest.raises(SystemExit, match="frontend stubs"):
            ttrain.main(["--device", "cpu", "--arch", arch, "--steps", "1",
                         "--ckpt", str(tmp_path / arch)])
