"""Port parity for the training substrates: optimizers and schedule,
synthetic data, the loader, the checkpointer, the train loop and the
launch step, held against the reference (``repro.optim``, ``repro.data``,
``repro.checkpoint``, ``repro.runtime``, ``repro.launch.steps``) on the
same numpy inputs, and to the criteria of ``tests/test_substrates.py``
and ``tests/test_train_serve.py``.

Across the two packages the optimizers are held on identical gradients,
and training by one step's gradients (``test_torch_train.py``) and a
5-step loss trajectory at 1e-3 relative, never by parameters after
several Adam steps: the first step maps near-zero gradients to ±lr, so
rounding noise flips their signs.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adafactor as jadafactor  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.schedule import warmup_cosine as jwarmup_cosine  # noqa
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.data import PrefetchLoader, SyntheticLM  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adafactor, adamw  # noqa: E402
from repro_torch.optim.adafactor import AdafactorConfig  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402
from repro_torch.runtime import TrainLoopCfg, train_loop  # noqa: E402
from repro_torch.tree import sorted_items, tree_leaves, tree_map  # noqa

jax.config.update("jax_enable_x64", False)
F32 = dict(rtol=2e-5, atol=2e-5)


def _np_tree(rng):
    """A small parameter-like tree: stacked, square, vector, odd leaves."""
    return {"blocks": {"w": rng.standard_normal((2, 160, 144)),
                       "b": rng.standard_normal((2, 144))},
            "embed": rng.standard_normal((200, 130)),
            "scale": rng.standard_normal((7,))}


def _f32(tree):
    return tree_map(lambda a: np.asarray(a, np.float32), tree)


def _bytes(a: np.ndarray) -> np.ndarray:
    return np.atleast_1d(a).view(np.uint8)


def _assert_tree_close(got, want, **tol):
    g, w = dict(sorted_items(got)), dict(sorted_items(want))
    assert set(g) == set(w)
    for path in w:
        a = g[path]
        a = a.float().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, np.asarray(w[path], np.float32),
                                   err_msg=str(path), **tol)


# -- optimizers and schedule --------------------------------------------------

@pytest.mark.parametrize("which", ["adamw", "adamw_bf16", "adafactor"])
def test_optimizer_matches_reference_on_identical_grads(which):
    """Three updates on the same gradients in both packages: parameters,
    optimizer state and the global norm at 2e-5; the step count exact."""
    rng = np.random.default_rng(0)
    params = _f32(_np_tree(rng))
    grads = [_f32(_np_tree(rng)) for _ in range(3)]
    if which == "adafactor":
        jcfg = jadafactor.AdafactorConfig(lr=1e-2, weight_decay=0.01)
        tcfg = AdafactorConfig(lr=1e-2, weight_decay=0.01)
        jinit, jupd = jadafactor.adafactor_init, jadafactor.adafactor_update
        tinit, tupd = adafactor.adafactor_init, adafactor.adafactor_update
    else:
        bf16 = which == "adamw_bf16"
        jcfg = jadamw.AdamWConfig(
            lr=1e-3, grad_clip=5.0,
            moment_dtype=jnp.bfloat16 if bf16 else jnp.float32)
        tcfg = AdamWConfig(lr=1e-3, grad_clip=5.0,
                           moment_dtype=torch.bfloat16 if bf16
                           else torch.float32)
        jinit, jupd = jadamw.adamw_init, jadamw.adamw_update
        tinit, tupd = adamw.adamw_init, adamw.adamw_update
    jp = tree_map(jnp.asarray, params)
    tp = convert.to_torch(params)
    jstate, tstate = jinit(jp, jcfg), tinit(tp, tcfg)
    for i, g in enumerate(grads):
        scale = 0.5 + 0.25 * i
        jp, jstate, jgn = jupd(jp, tree_map(jnp.asarray, g), jstate, jcfg,
                               scale)
        tp, tstate, tgn = tupd(tp, convert.to_torch(g), tstate, tcfg, scale)
        np.testing.assert_allclose(float(tgn), float(jgn), **F32)
    _assert_tree_close(tp, jax.tree.map(np.asarray, jp), **F32)
    jstate = jax.tree.map(np.asarray, jstate)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert tstate["step"].dtype == torch.int32
    tstate, jstate = dict(tstate), dict(jstate)
    tstate.pop("step"), jstate.pop("step")
    tol = dict(rtol=1e-2, atol=1e-6) if which == "adamw_bf16" else F32
    _assert_tree_close(tstate, jstate, **tol)


def test_adafactor_slices_large_stacked_leaves_as_the_reference():
    """A layer-stacked factored leaf over 2^24 elements: the reference
    updates (and RMS-clips) it one layer at a time; so does the port."""
    rng = np.random.default_rng(1)
    p = {"w": rng.standard_normal((2, 2048, 4100)).astype(np.float32)}
    g = {"w": (rng.standard_normal((2, 2048, 4100)) * np.array(
        [1.0, 50.0])[:, None, None]).astype(np.float32)}
    cfg = jadafactor.AdafactorConfig()
    jp, _, _ = jadafactor.adafactor_update(
        tree_map(jnp.asarray, p), tree_map(jnp.asarray, g),
        jadafactor.adafactor_init(tree_map(jnp.asarray, p), cfg), cfg)
    tp = convert.to_torch(p)
    tp, _, _ = adafactor.adafactor_update(
        tp, convert.to_torch(g), adafactor.adafactor_init(
            tp, AdafactorConfig()), AdafactorConfig())
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), **F32)


@pytest.mark.parametrize("step", [0, 1, 4, 5, 6, 50, 199, 200, 10000])
def test_warmup_cosine_matches_reference(step):
    kw = dict(warmup=5, total=200)
    np.testing.assert_allclose(float(warmup_cosine(step, **kw)),
                               float(jwarmup_cosine(step, **kw)), **F32)
    t = torch.tensor(step, dtype=torch.int32)
    assert float(warmup_cosine(t, **kw)) == float(warmup_cosine(step, **kw))


def _quad_params():
    return {"w": torch.tensor([3.0, -2.0, 1.5]),
            "b": torch.tensor([[1.0, -1.0], [2.0, 0.5]])}


@pytest.mark.parametrize("which", ["adamw", "adafactor"])
def test_optimizers_descend_quadratic(which):
    params = _quad_params()
    if which == "adamw":
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
        state = adamw.adamw_init(params, cfg)
        upd = adamw.adamw_update
    else:
        cfg = AdafactorConfig(lr=0.3, weight_decay=0.0, min_dim_factored=2)
        state = adafactor.adafactor_init(params, cfg)
        upd = adafactor.adafactor_update

    def loss(p):
        return sum(float(x.square().sum()) for x in tree_leaves(p))
    l0 = loss(params)
    for _ in range(60):
        grads = tree_map(lambda x: 2 * x, params)
        params, state, gn = upd(params, grads, state, cfg)
    assert loss(params) < 0.2 * l0
    assert np.isfinite(float(gn))


def test_adamw_grad_clip():
    params = {"w": torch.zeros(4)}
    cfg = AdamWConfig(lr=1.0, grad_clip=0.5, weight_decay=0.0)
    state = adamw.adamw_init(params, cfg)
    new, _, gn = adamw.adamw_update(params, {"w": torch.full((4,), 1e6)},
                                    state, cfg)
    assert float(gn) > 1e5
    assert torch.isfinite(new["w"]).all()
    assert float(new["w"].abs().max()) < 10.0


def test_adafactor_state_is_factored():
    cfg = AdafactorConfig(min_dim_factored=64)
    params = {"big": torch.zeros((256, 512)), "small": torch.zeros(8)}
    slots = adafactor.adafactor_init(params, cfg)["slots"]
    assert set(slots["big"]) == {"r", "c"}
    assert slots["big"]["r"].shape == (256,)
    assert slots["big"]["c"].shape == (512,)
    assert set(slots["small"]) == {"v"}
    factored = sum(x.numel() for x in tree_leaves(slots))
    assert factored < params["big"].numel() / 100


def test_opt_state_converts_both_ways():
    """AdamW's and Adafactor's states cross the converter and back, bits
    and the int32 step included."""
    rng = np.random.default_rng(2)
    jp = tree_map(jnp.asarray, _f32(_np_tree(rng)))
    for state in (jadamw.adamw_init(jp, jadamw.AdamWConfig(
            moment_dtype=jnp.bfloat16)),
                  jadafactor.adafactor_init(jp, jadafactor.AdafactorConfig())):
        host = jax.tree.map(np.asarray, state)
        t = convert.opt_state_to_torch(host)
        assert t["step"].dtype == torch.int32 and t["step"].dim() == 0
        back = convert.opt_state_to_numpy(t)
        for (pa, a), (pb, b) in zip(sorted_items(host), sorted_items(back)):
            assert pa == pb and a.dtype == b.dtype
            np.testing.assert_array_equal(_bytes(a), _bytes(b))
    with pytest.raises(ValueError, match="not an AdamW"):
        convert.opt_state_to_torch({"m": {}})


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 7, 123])
def test_synthetic_batches_equal_reference_bits(step):
    for vocab, seq, batch, seed in ((512, 64, 8, 0), (50304, 33, 3, 5)):
        got = SyntheticLM(vocab, seq, batch, seed).batch(step)
        want = JSyntheticLM(vocab, seq, batch, seed).batch(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_deterministic_and_learnable():
    ds = SyntheticLM(vocab=512, seq=64, global_batch=8)
    np.testing.assert_array_equal(ds.batch(7)["tokens"],
                                  ds.batch(7)["tokens"])
    assert not np.array_equal(ds.batch(7)["tokens"], ds.batch(8)["tokens"])
    b = ds.batch(0)
    assert (b["tokens"][:, 1:] == b["labels"][:, :-1]).all()
    assert ds.shard(3, 0, 2)["tokens"].shape[0] \
        + ds.shard(3, 1, 2)["tokens"].shape[0] == 8


def test_prefetch_loader_order_and_seek():
    ds = SyntheticLM(vocab=512, seq=16, global_batch=2)
    loader = PrefetchLoader(ds, "cpu")
    got = []
    for step, batch in loader:
        got.append(step)
        np.testing.assert_array_equal(batch["tokens"].numpy(),
                                      ds.batch(step)["tokens"])
        if step == 3:
            break
    loader.seek(10)
    step, batch = next(iter(loader))
    loader.stop()
    assert got == [0, 1, 2, 3] and step == 10 and loader.step == 11
    assert batch["labels"].dtype == torch.int32


# -- checkpointer -------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2, config_hash="h1")
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                        "h": torch.randn(4).bfloat16(), "n": {}},
             "opt": {"step": torch.tensor(5, dtype=torch.int32)}}
    for step in (10, 20, 30):
        ck.save(step, state, blocking=step == 30)
    ck.wait()
    assert ck.all_steps() == [20, 30]
    like = tree_map(torch.zeros_like, state)
    out = ck.restore(30, like)
    assert out["params"]["n"] == {}
    for (_, a), (_, b) in zip(sorted_items(out), sorted_items(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = json.loads((tmp_path / "step_000000030" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["params/h"]["dtype"] == "bfloat16"
    assert list(manifest["leaves"]) == ["opt/step", "params/h", "params/w"]


def test_checkpoint_async_save_snapshots_first(tmp_path):
    """A save copies the leaves before it returns: an in-place update
    right after does not reach the checkpoint."""
    ck = Checkpointer(tmp_path)
    w = torch.ones(1000)
    ck.save(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    assert float(ck.restore(1, {"w": w})["w"].max()) == 1.0


def test_checkpoint_config_hash_guard(tmp_path):
    Checkpointer(tmp_path, config_hash="abc").save(
        1, {"w": torch.ones(2)}, blocking=True)
    with pytest.raises(ValueError, match="hash"):
        Checkpointer(tmp_path, config_hash="DIFFERENT").restore(
            1, {"w": torch.zeros(2)})


def test_checkpoint_partial_write_ignored(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(5, {"w": torch.ones(2)}, blocking=True)
    (tmp_path / "step_000000009").mkdir()
    assert ck.latest_step() == 5


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"w": torch.ones(2)}, blocking=True)
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, {"w": torch.zeros(3)})


def _model_state(seed=0):
    """A reference model's bf16 params and AdamW state (bf16 moments
    after one update, so they are not zeros)."""
    cfg = get_smoke_config("olmo_1b")
    jp = jlm.init(jax.random.PRNGKey(seed), cfg)
    ocfg = jadamw.AdamWConfig(moment_dtype=jnp.bfloat16)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jp)
    jp, opt, _ = jadamw.adamw_update(jp, grads, jadamw.adamw_init(jp, ocfg),
                                     ocfg)
    return {"params": jp, "opt": opt}


def _assert_same_bits(torch_tree, jax_tree):
    host = jax.tree.map(np.asarray, jax_tree)
    t = dict(sorted_items(convert.to_numpy(torch_tree)))
    j = dict(sorted_items(host))
    assert set(t) == set(j)
    for path in j:
        assert t[path].dtype == j[path].dtype, path
        np.testing.assert_array_equal(_bytes(t[path]), _bytes(j[path]))


def test_checkpoint_written_by_reference_restores_in_port(tmp_path):
    state = _model_state()
    JCheckpointer(tmp_path, config_hash="c").save(3, state, blocking=True)
    like = convert.to_torch(jax.tree.map(np.asarray, state))
    like = tree_map(torch.zeros_like, like)
    out = Checkpointer(tmp_path, config_hash="c").restore(3, like)
    _assert_same_bits(out, state)


def test_checkpoint_written_by_port_restores_in_reference(tmp_path):
    state = _model_state(seed=1)
    tstate = convert.to_torch(jax.tree.map(np.asarray, state))
    Checkpointer(tmp_path, config_hash="c").save(4, tstate, blocking=True)
    like = jax.tree.map(lambda a: np.zeros_like(np.asarray(a)), state)
    out = JCheckpointer(tmp_path, config_hash="c").restore(4, like)
    _assert_same_bits(tstate, out)


# -- the train loop (tests/test_train_serve.py's criteria) --------------------

def _setup(tmp_path, fail_at=None, total=12):
    cfg = dataclasses.replace(get_smoke_config("olmo_1b"), star=None)
    tcfg = convert.model_cfg_from_reference(cfg)
    params = tlm.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    step_fn = steps.make_train_step(tcfg, lr=1e-3, warmup=5,
                                    total_steps=200)
    _, opt_init, _ = steps.make_optimizer(tcfg)
    ds = SyntheticLM(vocab=tcfg.vocab, seq=32, global_batch=4)
    loop = TrainLoopCfg(total_steps=total, ckpt_every=5,
                        ckpt_dir=str(tmp_path), log_every=4,
                        fail_at_step=fail_at)
    return tcfg, params, opt_init(params), step_fn, ds, loop


def _quiet(*_):
    pass


def test_training_reduces_loss(tmp_path):
    _, params, opt, step_fn, ds, loop = _setup(tmp_path, total=25)
    _, _, hist = train_loop(step_fn, params, opt, PrefetchLoader(ds, "cpu"),
                            loop, log_fn=_quiet)
    losses = [l for _, l in hist]
    assert losses[-1] < losses[0] - 0.1, f"no learning: {losses}"


def test_failure_recovery_checkpoint_restart(tmp_path):
    cfg, params, opt, step_fn, ds, loop = _setup(tmp_path, fail_at=8)
    with pytest.raises(RuntimeError, match="injected failure"):
        train_loop(step_fn, params, opt, PrefetchLoader(ds, "cpu"), loop,
                   log_fn=_quiet)
    assert Checkpointer(tmp_path).latest_step() == 5
    params2 = tlm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    _, opt_init, _ = steps.make_optimizer(cfg)
    _, opt2, _ = train_loop(step_fn, params2, opt_init(params2),
                            PrefetchLoader(ds, "cpu"),
                            dataclasses.replace(loop, fail_at_step=None),
                            log_fn=_quiet)
    assert int(opt2["step"]) == 12


def test_resume_matches_uninterrupted_bit_for_bit(tmp_path):
    """A run failed at step 7 and resumed from step 5 ends with the
    uninterrupted run's params and optimizer state, bit for bit (the
    reference's own test allows 2e-2)."""
    _, params, opt, step_fn, ds, loop = _setup(tmp_path / "a", total=10)
    pa, oa, _ = train_loop(step_fn, params, opt, PrefetchLoader(ds, "cpu"),
                           loop, log_fn=_quiet)
    cfg, params, opt, step_fn, ds, loop = _setup(tmp_path / "b", fail_at=7,
                                                 total=10)
    with pytest.raises(RuntimeError):
        train_loop(step_fn, params, opt, PrefetchLoader(ds, "cpu"), loop,
                   log_fn=_quiet)
    params2 = tlm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    _, opt_init, _ = steps.make_optimizer(cfg)
    pb, ob, _ = train_loop(step_fn, params2, opt_init(params2),
                           PrefetchLoader(ds, "cpu"),
                           dataclasses.replace(loop, fail_at_step=None),
                           log_fn=_quiet)
    for (_, a), (_, b) in zip(sorted_items({"p": pa, "o": oa}),
                              sorted_items({"p": pb, "o": ob})):
        assert torch.equal(a, b)


def test_loss_trajectory_matches_reference():
    """Five training steps of the reference's ``make_train_step`` and the
    port's from the same converted weights on the same batches: each
    step's loss at 1e-3 relative (fp32)."""
    jcfg = dataclasses.replace(get_smoke_config("olmo_1b"),
                               dtype=jnp.float32)
    jp = jlm.init(jax.random.PRNGKey(4), jcfg)
    tcfg = convert.model_cfg_from_reference(jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    kw = dict(lr=1e-3, warmup=2, total_steps=50)
    jstep = jax.jit(jsteps.make_train_step(jcfg, **kw))
    tstep = steps.make_train_step(tcfg, **kw)
    _, jinit, _, _ = jsteps.make_optimizer(jcfg)
    _, tinit, _ = steps.make_optimizer(tcfg)
    jopt, topt = jinit(jp), tinit(tp)
    ds = SyntheticLM(vocab=tcfg.vocab, seq=32, global_batch=4)
    for i in range(5):
        b = ds.batch(i)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        tp, topt, tm = tstep(tp, topt, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3)
    assert int(topt["step"]) == int(jopt["step"]) == 5


# -- chip_smoke.py's phase 20, rehearsed ---------------------------------------

def test_chip_smoke_training_phases_rehearse_on_cpu(monkeypatch, tmp_path):
    """Phase 20b-d on the CPU at smoke size: the training run's loss
    falls and every kernel count is 0 off the card (the plain forms run),
    the final save lands in ``build/`` and is removed, the restart run
    resumes bit-equal, and one step holds the 2x rule against the fp32
    plain path (here both paths are the plain forms)."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    import chip_smoke as cs
    monkeypatch.setattr(cs, "BUILD_DIR", tmp_path)
    cfg = dataclasses.replace(cs.olmo_1b.smoke_config(), star=None)
    gen = torch.Generator().manual_seed(0)
    out = cs.check_training(cfg, "cpu", gen, steps=25, seq=32, batch=4,
                            lr=1e-3)
    assert out["loss"][-1] < out["loss"][0] - 0.1
    assert out["launches"]["flash"] == out["launches"]["flash_bwd"] == 0
    assert out["save_bytes"] > 0 and not list(tmp_path.iterdir())
    try:
        restart = cs.restart_child(str(tmp_path / "r"), "cpu", cfg, seq=32,
                                   batch=2)
    finally:
        torch.use_deterministic_algorithms(False)
    assert restart["bit_equal"] and restart["leaves"] > 0
    assert restart["loss_resumed"] == restart["loss_uninterrupted"][5:]
    step = cs.check_model_step(cfg, "cpu", gen, layers=2, seq=64, batch=2)
    assert step["loss_rel_err"] < 2e-2 and step["grad_norm_rel_err"] < 2e-2
    assert set(step["leaves"]) == {
        "/".join(p) for p, _ in sorted_items(cs.lm.init(
            cfg, torch.Generator().manual_seed(0), "cpu"))}


def test_chip_smoke_family_training_phases_rehearse_on_cpu(monkeypatch,
                                                           tmp_path):
    """Phase 23 on the CPU at smoke size: K4's new shapes by 20a's rule
    (the plain forms), then OLMoE (AdamW), Grok-1 and Jamba's layer 0
    (Adafactor, ``train_accum`` 8, Jamba's pattern cut with its layer) and
    xLSTM trained by ``check_training``: the loss falls, MoE aux > 0,
    every kernel count 0 off the card, the optimizer's profiler range
    seen once in the profiled step whichever optimizer runs; their
    one-step gradients (the MoE ones routed as the kernel run routed, at
    2 layers or fewer); the remat policies bit-equal; the launch formula
    with accumulation and without remat; and 23c's restart with Adafactor
    state bit-equal."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    import chip_smoke as cs
    from repro_torch.configs import get_smoke_config as tsmoke
    monkeypatch.setattr(cs, "BUILD_DIR", tmp_path)
    ada = dict(optimizer="adafactor", train_accum=8)
    jamba = dataclasses.replace(tsmoke("jamba_1_5_large_398b"), **ada)
    case = functools.partial(cs.FamilyCase, seq=32, lr=1e-2)
    cases = {
        "olmoe_1b_7b": case(tsmoke("olmoe_1b_7b"), 2, 4, reduced={}),
        "grok_1_314b": case(dataclasses.replace(tsmoke("grok_1_314b"), **ada),
                            1, 8, reduced={"n_layers": "1 of 2"}),
        "jamba_1_5_large_398b": case(jamba, 1, 8,
                                     reduced={"n_layers": "1 of 8"}),
        "xlstm_125m": case(tsmoke("xlstm_125m"), 2, 4, reduced={})}
    gen = torch.Generator().manual_seed(0)
    out = cs.check_family_training("cpu", gen, cases=cases, steps=25,
                                   step_seq=32, remat_cfg=tsmoke("olmo_1b"))
    assert set(out["k4"]) == {"olmoe_1b_7b", "grok_1_314b"}
    assert out["k4"]["grok_1_314b"]["backward"]["BH"] == 4   # 1 row x 4
    for name, c in cases.items():
        cfg, layers = c.cfg, c.layers
        train = out[name]["train"]
        assert train["loss"][-1] < train["loss"][0] - 0.1, name
        assert train["layers"] == layers and train["reduced"] == c.reduced
        assert train["optimizer"] == cfg.optimizer
        assert set(train["launches"].values()) == {0}
        assert train["profiled_step"]["ranges_seen"] == {"optimizer": 1}
        moe = cs.moe_layers(cs.cut_layers(cfg, layers))
        assert all(a > 0 for a in train["aux"]) == bool(moe), name
        assert ("accum_buffer" in train["state_gb"]) == (
            cfg.train_accum > 1)
        step = out[name]["step"]
        assert step["held"] == bool(cs.attn_layers(cs.cut_layers(cfg,
                                                                 layers)))
        assert step["loss_rel_err"] < 2e-2
        assert (step["gate_calls"] or 0) == 2 * moe   # forward, recompute
        assert step["offload"] is False     # the host holds no card memory
    assert out["jamba_1_5_large_398b"]["step"]["reduced"] == {
        "n_layers": "1 of 8"}
    for remat in ("none", "dots"):
        assert out["remat"][remat]["loss_bit_equal"]
        assert out["remat"][remat]["leaves_differ"] == []
    grok = cs.cut_layers(cs.grok_1_314b.config(), 1)
    want = cs.training_launches(grok, 10)
    assert want["flash"] == 10 * 8 * 2 and want["flash_bwd"] == 10 * 8
    assert cs.training_launches(dataclasses.replace(grok, remat="none"),
                                1)["flash"] == 8
    try:
        restart = cs.restart_child(str(tmp_path / "r"), "cpu", jamba,
                                   seq=32, batch=8, layers=1)
    finally:
        torch.use_deterministic_algorithms(False)
    assert restart["bit_equal"] and restart["leaves"] > 0
    assert restart["optimizer"] == "adafactor"
    assert restart["loss_resumed"] == restart["loss_uninterrupted"][5:]
    state = cs.init_params(cs.cut_layers(jamba, 1), gen, "cpu")[0]
    opt = cs.launch_steps.make_optimizer(jamba, 1e-3)[1](state)
    assert restart["disk_needed_gb"] == cs.RESTART_STATE_COPIES * sum(
        t.numel() * t.element_size()
        for _, t in sorted_items({"p": state, "o": opt})) / 1e9


def test_chip_smoke_untrained_training_phase_rehearses_on_cpu(monkeypatch,
                                                              tmp_path):
    """Phase 27 on the CPU at smoke size: 27a's kernel checks (K4 and its
    backward at two BH, K2, K3 and K3's backward on the glue's selection
    at star_paper's tiles of 128; the plain versions run), 27b's one-step
    gradients of star_paper, ChatGLM3-6B and StarCoder2-15B (LayerNorm
    with bias, tanh-GELU, GQA 2), dense and with ``star_train`` (the plain
    runs on the kernel run's tile ids), and 27c's runs: the loss falls by
    0.1, every kernel count 0 off the card. Then the full configs' cases:
    their layers and cuts on ``reduced``, and the launch counts the card
    must show (K2 = K3 = 768 and K3's backward 384 in its wgmma form for
    star_paper; K4 = 672 and its backward 336 for ChatGLM3-6B dense;
    K2 = K3 = 672 and 336 with ``star_train``), and Jamba's case of phase
    23 still at layer 0, with why."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    import chip_smoke as cs
    from repro_torch.configs import get_smoke_config as tsmoke
    monkeypatch.setattr(cs, "BUILD_DIR", tmp_path)
    smoke = {name: dataclasses.replace(tsmoke(name), n_layers=2)
             for name in ("star_paper", "chatglm3_6b", "starcoder2_15b")}
    # star_paper's smoke config is the 100M example's (d 768, vocab
    # 32000): narrowed to the others' size, its tiles to 32 so that a
    # 128-token row has four to choose from
    sp = smoke["star_paper"]
    smoke["star_paper"] = dataclasses.replace(
        sp, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=512, q_chunk=64,
        seq_loss_chunk=64, vocab_pad_to=64,
        star=dataclasses.replace(sp.star, block_q=32, block_kv=32))
    step_cfgs = {}
    for name, cfg in smoke.items():
        step_cfgs[name] = cfg
        step_cfgs[f"{name}_star"] = dataclasses.replace(cfg, star_train=True)
    case = functools.partial(cs.FamilyCase, batch=4, seq=64, lr=1e-2)
    cases = {"star_paper_star": case(step_cfgs["star_paper_star"], 2,
                                     reduced={}),
             "chatglm3_6b": case(step_cfgs["chatglm3_6b"], 2, reduced={}),
             "chatglm3_6b_star": case(step_cfgs["chatglm3_6b_star"], 2,
                                      reduced={}),
             "starcoder2_15b": case(step_cfgs["starcoder2_15b"], 1,
                                    reduced={"n_layers": "1 of 2"})}
    gen = torch.Generator().manual_seed(0)
    out = cs.check_untrained_training(
        "cpu", gen, cases=cases, step_cfgs=step_cfgs, steps=25,
        step_seq=128, kernels_kw=dict(
            shapes_={"star_paper": 2, "starcoder2_15b": 3}, t=1024))
    k = out["kernels"]
    assert k["starcoder2_15b"]["backward"]["BH"] == 3
    assert k["star_paper"]["backward"]["two_calls_bit_equal"]
    assert k["star"]["sufa_bwd"]["form"] == "wgmma"
    assert k["star"]["sufa_bwd"]["keep"] == 2       # 0.2 of 8 tiles, up
    assert set(out["steps"]) == set(step_cfgs)
    for name, step in out["steps"].items():
        assert step["held"] and step["loss_rel_err"] < 2e-2, name
        assert not any(step["launches"].values())
        assert step["reduced"] == {"n_layers": "2 of 2"}
        assert (step["star"] is not None) == name.endswith("_star")
        assert step.get("star_calls") == (4 if name.endswith("_star")
                                          else None)   # 2 layers x remat
    for name in ("starcoder2_15b", "starcoder2_15b_star"):
        assert "blocks/b0/norm1/bias" in out["steps"][name]["leaves"]
    for name in ("chatglm3_6b", "chatglm3_6b_star"):
        assert "blocks/b0/core/bq" in out["steps"][name]["leaves"]
    for name, c in cases.items():
        train = out[name]["train"]
        assert train["loss"][-1] < train["loss"][0] - 0.1, name
        assert train["reduced"] == c.reduced and train["layers"] == c.layers
        assert train["star_train"] == name.endswith("_star")
        assert not any(train["launches"].values())
    full = cs.untrained_cases()
    assert {n: (c.layers, c.cfg.optimizer, c.cfg.train_accum, c.cfg.remat)
            for n, c in full.items()} == {
        "star_paper_star": (32, "adamw", 1, "full"),
        "chatglm3_6b": (28, "adamw", 1, "full"),
        "chatglm3_6b_star": (28, "adamw", 1, "full"),
        "starcoder2_15b": (cs.STARCODER2_TRAIN_LAYERS, "adamw", 1, "full")}
    assert full["starcoder2_15b"].reduced["n_layers"].startswith(
        f"{cs.STARCODER2_TRAIN_LAYERS} of 40")
    assert all(not c.reduced for n, c in full.items()
               if n != "starcoder2_15b")
    want = {n: cs.training_launches(cs.cut_layers(c.cfg, c.layers), 12)
            for n, c in full.items()}
    assert want["star_paper_star"]["dlzs_block"] == \
        want["star_paper_star"]["sufa"] == 768
    assert want["star_paper_star"]["sufa_bwd"] == \
        want["star_paper_star"]["sufa_bwd/wgmma"] == 384
    assert want["star_paper_star"]["flash"] == 0
    assert want["chatglm3_6b"]["flash"] == 672
    assert want["chatglm3_6b"]["flash_bwd"] == 336
    assert want["chatglm3_6b_star"]["sufa"] == 672
    assert want["chatglm3_6b_star"]["sufa_bwd/wgmma"] == 336
    assert want["chatglm3_6b_star"]["flash"] == 0
    assert want["starcoder2_15b"]["flash"] == \
        12 * 2 * cs.STARCODER2_TRAIN_LAYERS
    assert cs.untrained_kernel_shapes() == {"star_paper": 256,
                                            "starcoder2_15b": 384}
    # Jamba's layers 0-1 did not fit the card: phase 23c keeps layer 0,
    # with the measured reason on its line
    jamba = cs.family_cases()["jamba_1_5_large_398b"]
    assert jamba.layers == 1 and "layers 0-1" in jamba.reduced["n_layers"]
