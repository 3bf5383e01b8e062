"""Training beyond OLMo-1B, against the reference: three steps of
``repro.launch.steps.make_train_step`` (jitted) beside the port's on the
same converted weights and ``SyntheticLM`` batches, for the MoE (OLMoE,
Grok-1), hybrid (Jamba) and recurrent (xLSTM) smoke configs, Grok-1's and
Jamba's with their published optimizer and accumulation (Adafactor,
``train_accum`` 8); and the optimizers' blocked large-leaf updates
(AdamW's rows, ``global_norm``'s rows, Adafactor's one-slice leaf) against
the whole-leaf forms and the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.launch import steps as jsteps  # noqa: E402
from repro.optim import adafactor as jadafactor  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.optim import adafactor, adamw  # noqa: E402
from repro_torch.tree import sorted_items, tree_map  # noqa: E402
from test_torch_train import _models  # noqa: E402

ADAFACTOR_ACCUM = dict(optimizer="adafactor", train_accum=8)
F32 = dict(rtol=2e-5, atol=2e-5)


# -- three training steps against the reference --------------------------------

@pytest.mark.parametrize("arch,replaced,param_tol", [
    ("olmoe_1b_7b", {}, 2e-5),
    ("xlstm_125m", {}, 2e-5),
    ("grok_1_314b", ADAFACTOR_ACCUM, 5e-4),
    ("jamba_1_5_large_398b", ADAFACTOR_ACCUM, 5e-4),
])
def test_three_steps_match_reference(arch, replaced, param_tol):
    """Three steps from identical fp32 weights on identical batches (8 rows
    of 32 tokens): each step's loss at 1e-5 relative, the parameters after
    step 3 at ``param_tol`` scaled by max(1, |w|), the optimizer's step
    count exact. The AdamW cases hold at 2e-5 (these inputs give at most
    6.8e-6 scaled). Adafactor normalises each update by its RMS (and its
    factored second moment divides by a row mean), which scales the last
    fp32 bits of the two packages' gradients up to the size of the update:
    these inputs give 5.8e-5 (Grok-1) and 7.9e-5 (Jamba) scaled, so
    5e-4."""
    jcfg, jp, _, _ = _models(arch)
    jcfg = dataclasses.replace(jcfg, **replaced)
    tcfg = convert.model_cfg_from_reference(jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    kw = dict(lr=1e-3, warmup=2, total_steps=50)
    jstep = jax.jit(jsteps.make_train_step(jcfg, **kw))
    tstep = steps.make_train_step(tcfg, **kw)
    _, jinit, _, _ = jsteps.make_optimizer(jcfg)
    _, tinit, _ = steps.make_optimizer(tcfg)
    jopt, topt = jinit(jp), tinit(tp)
    ds = SyntheticLM(vocab=tcfg.vocab, seq=32, global_batch=8)
    for i in range(3):
        b = ds.batch(i)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        tp, topt, tm = tstep(tp, topt, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
    assert int(topt["step"]) == int(jopt["step"]) == 3
    want = dict(sorted_items(jax.tree.map(np.asarray, jp)))
    got = dict(sorted_items(tp))
    assert set(got) == set(want)
    for path, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[path].numpy(), w, rtol=param_tol,
                                   atol=param_tol * scale, err_msg=str(path))


# -- the blocked large-leaf updates ---------------------------------------------

def _leaves(rng):
    """Above the lowered threshold: 48 rows (48 blocks of 1 row, the
    reference's largest divisor up to 64), 96 rows (48 blocks of 2), a
    prime 67 rows (no block: 67 has no divisor up to 64 but 1); under it:
    a small matrix and a vector."""
    return {"a": rng.standard_normal((48, 5, 7)),
            "b": rng.standard_normal((96, 11)),
            "c": rng.standard_normal((67, 9)),
            "small": rng.standard_normal((3, 4)),
            "vec": rng.standard_normal((6,))}


THRESHOLD = 60      # lowered: every leaf above but "small" and "vec"


def _counting(row_blocks, log: list):
    """``row_blocks`` that logs (shape, cap, blocks) of every call."""
    def counted(x, cap):
        n = row_blocks(x, cap)
        log.append((tuple(x.shape), cap, n))
        return n
    return counted


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_adamw_blocked_update_gives_whole_leaf_bits(monkeypatch, moments):
    """Three AdamW steps with the threshold lowered give the whole-leaf
    form's bits in params and both moments, each leaf taken in the
    reference's block count (``_divisor_leq(shape[0], 64)`` above the
    threshold, 1 under it)."""
    rng = np.random.default_rng(0)
    params = _leaves(rng)
    grads = [_leaves(rng) for _ in range(3)]
    real_row_blocks = adamw.row_blocks
    cfg = adamw.AdamWConfig(lr=1e-2, grad_clip=5.0, moment_dtype=moments)
    runs = {}
    for form, threshold in (("whole", adamw.SLICE_ELEMENTS),
                            ("blocked", THRESHOLD)):
        monkeypatch.setattr(adamw, "SLICE_ELEMENTS", threshold)
        blocks = []
        monkeypatch.setattr(adamw, "row_blocks",
                            _counting(real_row_blocks, blocks))
        p = convert.to_torch(params)
        state = adamw.adamw_init(p, cfg)
        for i, g in enumerate(grads):
            p, state, _ = adamw.adamw_update(p, convert.to_torch(g), state,
                                             cfg, 0.5 + 0.25 * i)
        runs[form] = (p, state, blocks)
    whole, blocked = runs["whole"], runs["blocked"]
    pairs = zip(sorted_items({"p": whole[0], "s": whole[1]}),
                sorted_items({"p": blocked[0], "s": blocked[1]}))
    for (path, a), (path_b, b) in pairs:
        assert path == path_b and torch.equal(a, b), path
    took = {shape: n for shape, cap, n in blocked[2] if cap == 64}
    for leaf in params.values():
        above = leaf.size > THRESHOLD and leaf.ndim >= 2
        want = jadamw._divisor_leq(leaf.shape[0], 64) if above else 1
        assert took[leaf.shape] == want
    assert took[(48, 5, 7)] == 48 and took[(96, 11)] == 48
    assert took[(67, 9)] == 1
    assert all(n == 1 for _, _, n in whole[2])


def test_blocked_global_norm_matches_reference(monkeypatch):
    """``global_norm`` with the port's threshold lowered (rows summed
    block by block in fp32, ``_divisor_leq(shape[0], 32)`` blocks) against
    the reference's whole-leaf sums of the same leaves, at 2e-5."""
    rng = np.random.default_rng(1)
    tree = tree_map(lambda a: np.asarray(a * 30, np.float32), _leaves(rng))
    monkeypatch.setattr(adamw, "SLICE_ELEMENTS", THRESHOLD)
    assert adamw.row_blocks(torch.zeros(96, 11), 32) == 32
    got = float(adamw.global_norm(convert.to_torch(tree)))
    want = float(jadamw.global_norm(tree_map(jnp.asarray, tree)))
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("shape", [(1, 3, 160, 144), (2, 2, 2048, 2056)])
def test_adafactor_blocked_slices_match_reference(monkeypatch, shape):
    """A factored leaf whose slices each hold several [a, b] blocks, with
    the port's threshold lowered: one slice (the reference updates the
    leaf whole) and two slices (a leaf above the reference's 2^24, which
    it updates a slice at a time). With the row block lowered to one
    [a, b] block, the port updates each slice in three passes over its
    blocks (the factors, the update's sum of squares, then the update);
    three steps agree with the reference at the optimizer test's 2e-5
    (the column means and the sum of squares are summed in another order:
    not bits)."""
    rng = np.random.default_rng(2)
    p = {"w": rng.standard_normal(shape).astype(np.float32)}
    scale = np.array([1.0, 40.0, 0.1])[:shape[1]][None, :, None, None]
    gs = [{"w": (rng.standard_normal(shape) * scale).astype(np.float32)}
          for _ in range(3)]
    monkeypatch.setattr(adafactor, "SLICE_ELEMENTS", 1000)
    monkeypatch.setattr(adafactor, "ROW_BLOCK_ELEMENTS",
                        int(np.prod(shape[-2:])))
    calls = []
    real = adafactor._update_blocked

    def update_blocks(*args):
        calls.append(args[1].shape)
        return real(*args)
    monkeypatch.setattr(adafactor, "_update_blocked", update_blocks)
    jcfg = jadafactor.AdafactorConfig(lr=1e-2, weight_decay=0.01)
    tcfg = adafactor.AdafactorConfig(lr=1e-2, weight_decay=0.01)
    jp = tree_map(jnp.asarray, p)
    tp = convert.to_torch(p)
    jstate, tstate = jadafactor.adafactor_init(jp, jcfg), \
        adafactor.adafactor_init(tp, tcfg)
    for g in gs:
        jp, jstate, _ = jadafactor.adafactor_update(
            jp, tree_map(jnp.asarray, g), jstate, jcfg)
        tp, tstate, _ = adafactor.adafactor_update(
            tp, convert.to_torch(g), tstate, tcfg)
    assert calls == [shape[1:]] * (3 * shape[0])
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), **F32)
    for key in ("r", "c"):
        np.testing.assert_allclose(
            tstate["slots"]["w"][key].numpy(),
            np.asarray(jstate["slots"]["w"][key]), **F32)
