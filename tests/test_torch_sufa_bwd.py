"""Port parity for K3's gradient (STAR in training): the plain backward
``kernels.sufa.sufa_bwd_ref`` against autograd through the plain forward
(``kernels.sufa.sufa_reference``) and against ``jax.grad`` of the
reference's ``core.sufa.sufa_gathered`` and ``sufa_scan`` in fp32 at
2e-5 (causal and not, T < S, invalid slots, a q-tile with none valid, a
key tile no q-tile chose); the differentiable wrapper (``_Sufa``) and
its lse on the CPU; and ``chip_smoke.py``'s phase 21 rehearsed at smoke
size.

The CUDA kernels run only on a GPU: ``tests/test_torch_cuda.py`` holds
K3's lse and its backward against these plain versions on the card.
"""

import dataclasses
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.sads import BlockSelection  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.kernels import sufa as ksufa  # noqa: E402
from test_torch_train import F32  # noqa: E402

jax.config.update("jax_enable_x64", False)
# the module, not the function ``repro.core`` exports under its name
jsufa = importlib.import_module("repro.core.sufa")
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _selection(bh, n_qt, n_kt, keep, rng, *, causal, spare_last=False):
    """Random distinct tile ids per q-tile (the causally visible ones
    first when ``causal``), all valid; with ``spare_last`` head 0 never
    names the last key tile."""
    idx = np.zeros((bh, n_qt, keep), np.int64)
    for b in range(bh):
        n = n_kt - 1 if spare_last and b == 0 else n_kt
        for qt in range(n_qt):
            seen = min(n, qt + 1 + n_kt - n_qt) if causal else n
            idx[b, qt] = np.concatenate([rng.permutation(seen), seen
                                         + rng.permutation(n - seen)])[:keep]
    return idx, np.ones((bh, n_qt, keep), bool)


# (T, S, causal, edges): edges marks slot 1 of q-tile 1 invalid, q-tile 0
# of head 1 with no valid slot and the last key tile of head 0 unchosen
SUFA_CASES = [(64, 64, True, False), (64, 64, False, True),
              (32, 64, True, True), (64, 64, True, True)]


def _sufa_case(t, s, causal, edges, *, bh=3, d=16, block=16, keep=2):
    rng = np.random.default_rng(t + s + 10 * causal + 100 * edges)
    q = rng.standard_normal((bh, t, d)).astype(np.float32)
    k = rng.standard_normal((bh, s, d)).astype(np.float32)
    v = rng.standard_normal((bh, s, d)).astype(np.float32)
    do = rng.standard_normal((bh, t, d)).astype(np.float32)
    n_qt, n_kt = t // block, s // block
    idx, valid = _selection(bh, n_qt, n_kt, keep, rng, causal=causal,
                            spare_last=edges)
    if edges:
        valid[:, 1, 1] = False
        valid[1, 0] = False
    return [torch.from_numpy(x) for x in (q, k, v, idx, valid, do)]


def _jax_sufa_grads(q, k, v, idx, valid, mask, do, *, block, scale, scan,
                    strict):
    """``jax.grad`` of the reference's gathered or streaming SU-FA, one
    head at a time, fed the port's tile ids and its validity x causal
    element mask."""
    ids = jnp.asarray(idx.numpy().astype(np.int32))
    ok = jnp.asarray(valid.numpy())
    em = jnp.asarray(mask.numpy())
    dj = jnp.asarray(do.numpy())

    def one(qh, kh, vh, ih, vh_ok, mh):
        sel = BlockSelection(ih, vh_ok, jnp.zeros(ih.shape, jnp.float32))
        if scan:
            return jsufa.sufa_scan(qh, kh, vh, sel, scale=scale,
                                   block_q=block, block_kv=block,
                                   strict=strict, elem_mask=mh)
        return jsufa.sufa_gathered(qh, kh, vh, sel, scale=scale,
                                   block_q=block, block_kv=block,
                                   elem_mask=mh)

    def f(qj, kj, vj):
        return jnp.sum(jax.vmap(one)(qj, kj, vj, ids, ok, em) * dj)
    grads = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("t,s,causal,edges", SUFA_CASES)
def test_sufa_bwd_ref_matches_autograd_and_reference(t, s, causal, edges):
    """``sufa_bwd_ref`` on the forward's own o and lse against autograd
    through the plain forward (strict and fast) and against ``jax.grad``
    of the reference's ``sufa_gathered`` and ``sufa_scan`` (strict and
    fast), fp32 at 2e-5; a key tile no q-tile chose gets dK = dV = 0 and
    a q-tile with no valid slot dQ = 0, exactly."""
    block, d = 16, 16
    q, k, v, idx, valid, do = _sufa_case(t, s, causal, edges)
    scale = d ** -0.5
    kw = dict(block_q=block, block_kv=block, causal=causal, scale=scale)
    o, lse = ksufa.sufa_reference(q, k, v, idx, valid, strict=True,
                                  return_lse=True, **kw)
    got = ksufa.sufa_bwd_ref(q, k, v, idx, valid, o, lse, do, **kw)
    wants = []
    for strict in (True, False):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = ksufa.sufa_reference(*leaves, idx, valid, strict=strict, **kw)
        wants.append([g.numpy() for g in torch.autograd.grad(out, leaves,
                                                             do)])
    _, _, mask = ksufa.gather_selected(k, v, idx, valid, t=t, block_q=block,
                                       block_kv=block, causal=causal)
    for scan, strict in ((False, True), (True, True), (True, False)):
        wants.append(_jax_sufa_grads(q, k, v, idx, valid, mask, do,
                                     block=block, scale=scale, scan=scan,
                                     strict=strict))
    for want in wants:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **F32)
    if edges:
        assert torch.isinf(lse[1, :block]).all()
        assert float(got[0][1, :block].abs().max()) == 0.0
        assert float(got[1][0, -block:].abs().max()) == 0.0
        assert float(got[2][0, -block:].abs().max()) == 0.0


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("t,s,causal,edges", SUFA_CASES[1:3])
def test_sufa_function_on_cpu_is_the_plain_gradient(t, s, causal, edges,
                                                    strict):
    """The differentiable wrapper on the CPU (``_Sufa``): its forward is
    the plain forward bit for bit, its gradient ``sufa_bwd_ref`` on that
    forward's o and lse bit for bit, and autograd through the plain
    forward's at 2e-5; its lse is the log-sum-exp of the visible scores
    (+inf where none is), the same in both modes."""
    block = 16
    q, k, v, idx, valid, do = _sufa_case(t, s, causal, edges)
    kw = dict(block_q=block, block_kv=block, causal=causal)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ksufa.sufa_attention(*leaves, idx, valid, strict=strict, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    o, lse = ksufa.sufa_attention(q, k, v, idx, valid, strict=strict,
                                  return_lse=True, **kw)
    assert torch.equal(out.detach(), o)
    assert torch.equal(got[0], ksufa.sufa_bwd_ref(
        q, k, v, idx, valid, o, lse, do, scale=q.shape[-1] ** -0.5,
        **kw)[0])
    plain_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    plain = ksufa.sufa_reference(*plain_leaves, idx, valid, strict=strict,
                                 scale=q.shape[-1] ** -0.5, **kw)
    for g, w in zip(got, torch.autograd.grad(plain, plain_leaves, do)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F32)
    kg, _, mask = ksufa.gather_selected(k, v, idx, valid, t=t,
                                        block_q=block, block_kv=block,
                                        causal=causal)
    sc = torch.einsum("bqtd,bqjcd->bqtjc",
                      q.reshape(q.shape[0], t // block, block, -1), kg)
    sc = (sc * q.shape[-1] ** -0.5).masked_fill(~mask.transpose(2, 3),
                                                -torch.inf)
    want = torch.logsumexp(sc.flatten(-2), dim=-1).reshape(lse.shape)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    fin = torch.isfinite(want)
    np.testing.assert_allclose(lse[fin].numpy(), want[fin].numpy(), **F32)


# -- chip_smoke.py's phase 21, rehearsed ---------------------------------------

def test_chip_smoke_star_training_phases_rehearse_on_cpu(monkeypatch,
                                                         tmp_path):
    """Phase 21 on the CPU at smoke size (tiles of 16; the plain versions
    run, so every kernel count stays 0): 21a's lse and backward checks
    (causal with the edges, not causal, T < S), the training run with
    ``star_train`` (the loss falls by 0.1), the restart run bit-equal,
    and one step against the fp32 plain path on the kernel run's tiles
    (the recompute's selection the forward's)."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs
    monkeypatch.setattr(cs, "BUILD_DIR", tmp_path)
    for t, s, causal, edges in ((128, 128, True, True),
                                (128, 128, False, False),
                                (64, 128, True, False)):
        out = cs.check_sufa_bwd("cpu", None, bh=4, t=t, s=s, d=16,
                                causal=causal, seed=t + s, timed=False,
                                edges=edges, block=16)
        assert out["two_calls_bit_equal"]
        assert out["fast"]["two_calls_bit_equal"]
        assert out["lse_max_abs_err"] <= 1e-4 and out["keep"] >= 2
        if edges:
            assert out["unchosen_dk_dv_zero"] and out["empty_q_tile_dq_zero"]
    cfg = dataclasses.replace(cs.olmo_1b.smoke_config(), star_train=True)
    gen = torch.Generator().manual_seed(0)
    out = cs.check_training(cfg, "cpu", gen, steps=25, seq=32, batch=4,
                            lr=1e-3)
    assert out["star_train"] and out["loss"][-1] < out["loss"][0] - 0.1
    assert not any(out["launches"].values())
    assert out["save_bytes"] > 0 and not list(tmp_path.iterdir())
    try:
        restart = cs.restart_child(str(tmp_path / "r"), "cpu", cfg, seq=32,
                                   batch=2)
    finally:
        torch.use_deterministic_algorithms(False)
    assert restart["bit_equal"] and restart["star_train"]
    step = cs.check_model_step(cfg, "cpu", gen, layers=2, seq=64, batch=2)
    assert step["loss_rel_err"] < 2e-2 and step["grad_norm_rel_err"] < 2e-2
    assert step["star_calls"] == 4 and step["recompute_selection_equal"]
