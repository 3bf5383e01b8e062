"""The port's bf16 training gradient against the reference's, on the
same bf16 params, at init and after training: olmo_1b's smoke config,
dense and with ``star_train``. Each leaf of the port's bf16 gradient
must lie no further from the reference's fp32 gradient than twice the
reference's own bf16 gradient does (plus 1e-5), phase 20a's rule at
model level. The fp32 parity of the same step is
``test_torch_star_train.py``'s and ``test_torch_train.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import convert  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.tree import sorted_items  # noqa: E402
from test_torch_star_train import _star_models  # noqa: E402
from test_torch_train import _jax_value_and_grad, _torch_batch  # noqa: E402


def _bf16_grads_within_rule(jcfg, tp, tcfg, batch):
    """Every leaf of the port's bf16 gradient no further from the
    reference's fp32 gradient than twice the reference's bf16 gradient is
    (plus 1e-5), all three on the same bf16 params: phase 20a's rule at
    model level."""
    jparams = jax.tree.map(jnp.asarray, convert.to_numpy(tp))
    _, got = steps.value_and_grad(tp, tcfg, _torch_batch(batch))
    _, lowp = _jax_value_and_grad(jcfg, jparams, batch)
    _, want = _jax_value_and_grad(
        dataclasses.replace(jcfg, dtype=jnp.float32),
        jax.tree.map(lambda a: a.astype(jnp.float32), jparams), batch)
    got = dict(sorted_items(got))
    lowp = dict(sorted_items(jax.tree.map(np.asarray, lowp)))
    for path, w in sorted_items(jax.tree.map(np.asarray, want)):
        err = np.abs(got[path].float().numpy() - w).max()
        ref_err = np.abs(lowp[path].astype(np.float32) - w).max()
        assert err <= 2 * ref_err + 1e-5, (path, err, ref_err)


@pytest.mark.parametrize("variant", ["dense", "star_every_tile"])
def test_bf16_grads_track_reference_before_and_after_training(variant):
    """olmo_1b in bf16, dense or with ``star_train``: the port's gradient
    by ``_bf16_grads_within_rule`` at init and after 10 of the port's
    AdamW steps. STAR keeps every tile here (``top_k_ratio`` 1, radius
    1e4): in bf16 the tile estimates tie, and a last-bit difference
    between the two packages' q or k changes the tiles a sparse selection
    keeps, which makes another function."""
    star = None if variant == "dense" else {"top_k_ratio": 1.0,
                                             "radius": 1e4}
    jcfg, _, tcfg, tp = _star_models("olmo_1b", star or {},
                                     dtype=jnp.bfloat16)
    if star is None:
        jcfg = dataclasses.replace(jcfg, star=None)
        tcfg = convert.model_cfg_from_reference(jcfg)
    _, opt_init, _ = steps.make_optimizer(tcfg, 1e-3)
    opt = opt_init(tp)
    train = steps.make_train_step(tcfg, lr=1e-3, warmup=2, total_steps=10)
    data = SyntheticLM(vocab=tcfg.vocab, seq=64, global_batch=4)
    _bf16_grads_within_rule(jcfg, tp, tcfg, data.batch(0))
    for i in range(10):
        tp, opt, _ = train(tp, opt, _torch_batch(data.batch(i)))
    _bf16_grads_within_rule(jcfg, tp, tcfg, data.batch(10))
