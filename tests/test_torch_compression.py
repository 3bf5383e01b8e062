"""Port parity: ``repro_torch.optim.compression`` against
``repro.optim.compression`` on identical inputs, and held to the criteria
of ``tests/test_substrates.py``'s compression tests.

The int8 path is the same fp32 arithmetic in both packages, so its
decompressed gradients and residuals are equal bit for bit; top-k keeps
the same entries (ties to the lower index, as ``jax.lax.top_k``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402


def _grads(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((1024,)).astype(np.float32) * 3,
            "blk": {"w": rng.standard_normal((33, 17)).astype(np.float32),
                    "b": rng.standard_normal((5,)).astype(np.float32)}}


def _to(mod, tree):
    conv = jnp.asarray if mod is jcomp else torch.from_numpy
    return {k: _to(mod, v) if isinstance(v, dict) else conv(v)
            for k, v in tree.items()}


def _flat(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


@pytest.mark.parametrize("kind,kw", [("int8", dict(block=128)),
                                     ("int8", dict(block=256)),
                                     ("topk", dict(topk_ratio=0.05)),
                                     ("topk", dict(topk_ratio=0.25)),
                                     ("none", {})])
def test_compress_tree_equal_over_steps(kind, kw):
    """Three error-feedback steps on the same gradients: the decompressed
    gradients and residuals equal the reference's bit for bit."""
    jcfg = jcomp.CompressionCfg(kind=kind, **kw)
    tcfg = tcomp.CompressionCfg(kind=kind, **kw)
    jef = tef = None
    for step in range(3):
        g = _grads(step)
        jg, jef = jcomp.compress_tree(_to(jcomp, g), jef, jcfg)
        tg, tef = tcomp.compress_tree(_to(tcomp, g), tef, tcfg)
        for (jp, ja), (tp, ta) in zip(list(_flat(jg)) + list(_flat(jef)),
                                      list(_flat(tg)) + list(_flat(tef))):
            assert jp == tp
            np.testing.assert_array_equal(ta, ja, err_msg=f"{kind} {jp}")
    assert tcomp.compressed_bytes(_to(tcomp, g), tcfg) == \
        jcomp.compressed_bytes(_to(jcomp, g), jcfg)


def test_topk_ties_go_to_the_lower_index():
    g = {"g": np.array([1.0, -3.0, 3.0, 2.0, -3.0, 0.5], np.float32)}
    cfg_kw = dict(kind="topk", topk_ratio=0.34)     # k = 2 of 6
    jg, _ = jcomp.compress_tree(_to(jcomp, g), None,
                                jcomp.CompressionCfg(**cfg_kw))
    tg, _ = tcomp.compress_tree(_to(tcomp, g), None,
                                tcomp.CompressionCfg(**cfg_kw))
    np.testing.assert_array_equal(tg["g"].numpy(), np.asarray(jg["g"]))
    np.testing.assert_array_equal(tg["g"].numpy(),
                                  [0, -3.0, 3.0, 0, 0, 0])


def test_int8_compression_bounded_error():
    """``test_substrates.test_int8_compression_bounded_error``'s criteria."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1024).astype(np.float32) * 3)
    ghat, resid = tcomp.compress_tree(
        {"g": g}, None, tcomp.CompressionCfg(kind="int8", block=128))
    err = (ghat["g"] - g).abs()
    assert float(err.max()) <= 3 * float(g.abs().max()) / 127
    np.testing.assert_allclose((ghat["g"] + resid["g"]).numpy(), g.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_error_feedback_converges():
    """``test_substrates.test_error_feedback_converges``'s criteria."""
    cfg = tcomp.CompressionCfg(kind="topk", topk_ratio=0.25)
    rng = np.random.default_rng(1)
    ef, total_hat, total = None, torch.zeros(256), torch.zeros(256)
    for _ in range(30):
        g = {"g": torch.from_numpy(rng.standard_normal(256).astype(
            np.float32))}
        ghat, ef = tcomp.compress_tree(g, ef, cfg)
        total_hat += ghat["g"]
        total += g["g"]
    assert float(torch.linalg.norm(total_hat - total)
                 / torch.linalg.norm(total)) < 0.5
    np.testing.assert_allclose((total_hat + ef["g"]).numpy(), total.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_compressed_bytes_accounting():
    """``test_substrates.test_compressed_bytes_accounting``'s criteria,
    and the byte counts themselves."""
    g = {"a": torch.zeros(1000), "b": torch.zeros((32, 32))}
    dense = tcomp.compressed_bytes(g, tcomp.CompressionCfg(kind="none"))
    int8 = tcomp.compressed_bytes(g, tcomp.CompressionCfg(kind="int8"))
    topk = tcomp.compressed_bytes(g, tcomp.CompressionCfg(
        kind="topk", topk_ratio=0.05))
    assert int8 < dense / 3 and topk < dense / 5
    assert dense == 4 * 2024
    assert int8 == 2024 + 4 * (1000 // 256 + 1 + 1024 // 256 + 1)
    assert topk == 8 * (50 + 51)
