"""K1's host side: the split plan and the plain split-and-merge form.

The CUDA kernel splits each sequence's block table into ``split_plan``
ranges: each range gives its softmax statistics, which merge in split
order, and then its share of P·V. Here the plan's cover of the slots is
checked, and the plain form of that algorithm
(``kernels.ref.paged_decode_split_ref``) is held in fp32 at 2e-5 (the
reference tests' bound) against the JAX Pallas kernel
``repro.kernels.paged.paged_decode_attention`` in interpret mode and
against ``paged_gather_decode``, and in bf16 against the latter. Inputs
are drawn with numpy from fixed seeds; tests/test_torch_cuda.py holds the
kernel against its plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from _hypothesis_shim import hypothesis, st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels import paged as jpaged  # noqa: E402
from repro_torch.kernels import paged as kpaged  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kvcache import paged_attention as tpa  # noqa: E402

FP32 = dict(rtol=2e-5, atol=2e-5)


def _check_plan(b, g, w, page):
    n = kpaged.split_plan(b, g, w, page)
    assert 1 <= n <= w
    ranges = kpaged.split_ranges(w, n)
    slots = [s for w0, w1 in ranges for s in range(w0, w1)]
    assert slots == list(range(w))                 # each slot exactly once
    assert all(w1 > w0 for w0, w1 in ranges)       # no empty range
    # the kernel holds P for at most MAX_RANGE_ROWS rows of a range
    assert max(w1 - w0 for w0, w1 in ranges) * page <= kpaged.MAX_RANGE_ROWS
    most = max(1, min(w, w * page // kpaged.STAGE_ROWS))
    need = -(-w // (kpaged.MAX_RANGE_ROWS // page))
    target = kpaged.SMS * kpaged.BLOCKS_PER_SM
    assert n * b * g >= target or n == max(most, need)


@pytest.mark.parametrize("b,g,w,page", [
    (1, 1, 1, 16), (1, 1, 8, 16), (4, 16, 64, 16), (3, 16, 130, 16),
    (33, 16, 64, 16), (33, 8, 64, 16), (2, 2, 3, 4), (8, 4, 200, 4),
    (64, 16, 2, 16), (1, 32, 1000, 16), (5, 3, 7, 1), (528, 1, 9, 16)])
def test_split_plan_covers_slots(b, g, w, page):
    """Every slot in exactly one non-empty range, never more splits than
    slots, no range over MAX_RANGE_ROWS rows, and either the block-count
    target met or the most splits the table allows."""
    _check_plan(b, g, w, page)


@hypothesis.settings(max_examples=200, deadline=None)
@hypothesis.given(b=st.integers(1, 64), g=st.integers(1, 32),
                  w=st.integers(1, 512),
                  page=st.sampled_from([1, 4, 8, 16, 32]))
def test_split_plan_property(b, g, w, page):
    _check_plan(b, g, w, page)


def test_split_plan_served_shapes():
    """The plans of the card's decode shapes: B 4, W 64 (the main path)
    and B 3, W 130 (the whole-prompt phase), 16 KV heads, page 16."""
    assert kpaged.split_plan(4, 16, 64, 16) == 9
    assert kpaged.split_plan(3, 16, 130, 16) == 11


def _inputs(seed, b=3, g=2, r=2, d=8, n_pages=13, page=4, w=6,
            kv_len=(24, 9, 0)):
    """A full table, one whose later slots lie wholly past kv_len (and
    one padded slot inside), and a sequence with kv_len 0."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, g, r, d).astype(np.float32)
    kp = rng.randn(n_pages, page, g, d).astype(np.float32)
    vp = rng.randn(n_pages, page, g, d).astype(np.float32)
    phys = np.stack([rng.permutation(n_pages - 1)[:w] + 1
                     for _ in range(b)]).astype(np.int32)
    logical = np.tile(np.arange(w, dtype=np.int32), (b, 1))
    phys[1, 4], logical[1, 4] = 0, -1
    return q, kp, vp, phys, logical, np.asarray(kv_len, np.int32)


def _jax_kernel(q, kp, vp, phys, logical, kv_len, scale):
    """The Pallas kernel in interpret mode: pool as [G, P, page, d]."""
    out = jpaged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(np.moveaxis(kp, 2, 0)),
        jnp.asarray(np.moveaxis(vp, 2, 0)), jnp.asarray(phys),
        jnp.asarray(logical), jnp.asarray(kv_len), scale=scale,
        interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("n_split", [1, 2, 3, 6])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_merge_matches_references(n_split, seed):
    """The plain split-and-merge against the Pallas kernel and the plain
    gather, fp32 at 2e-5, for 1, 2, 3 and W splits."""
    arrays = _inputs(seed)
    q, kp, vp, phys, logical, kv_len = arrays
    scale = q.shape[-1] ** -0.5
    t = [torch.from_numpy(a.copy()) for a in arrays]
    got, _ = kref.paged_decode_split_ref(*t, scale=scale, n_split=n_split)
    want = _jax_kernel(*arrays, scale)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    b, g, r, d = q.shape
    gather = tpa.paged_gather_decode(t[0].reshape(b, g * r, d), *t[1:],
                                     n_kv=g, scale=scale)
    np.testing.assert_allclose(got.numpy(), gather.reshape(b, g, r, d)
                               .numpy(), **FP32)
    assert float(got[2].abs().max()) == 0.0        # kv_len 0 gives 0


def test_split_states_past_kv_len_weigh_nothing():
    """Splits wholly past kv_len (or of a sequence with kv_len 0) hold
    l = 0 and m = NEG_INF; the live splits' states merge to the answer."""
    arrays = _inputs(2)
    t = [torch.from_numpy(a.copy()) for a in arrays]
    _, (m, l, o) = kref.paged_decode_split_ref(*t, scale=0.35, n_split=6)
    # sequence 1: kv_len 9 fills slots 0-2; slot 4 is padding
    assert bool((l[3:, 1] == 0).all()) and bool((l[:3, 1] > 0).all())
    assert bool((m[3:, 1] <= kref.NEG_INF / 2).all())
    assert bool((l[:, 2] == 0).all()) and bool((o[:, 2] == 0).all())
    assert bool((l[:, 0] > 0).all())


@pytest.mark.parametrize("n_split", [1, 3])
def test_split_merge_rounds_as_the_plain_gather(n_split):
    """In bf16 the split-and-merge rounds scores and the normalised P
    where ``paged_gather_decode`` rounds them: bf16 at 2e-2
    (tests/test_kernels.py's bound) on the same inputs."""
    arrays = _inputs(3, d=64)
    t = [torch.from_numpy(a.copy()) for a in arrays]
    t[:3] = [x.to(torch.bfloat16) for x in t[:3]]
    got, _ = kref.paged_decode_split_ref(*t, scale=0.125, n_split=n_split)
    b, g, r, d = t[0].shape
    want = tpa.paged_gather_decode(t[0].reshape(b, g * r, d), *t[1:],
                                   n_kv=g, scale=0.125)
    np.testing.assert_allclose(got.float().numpy(),
                               want.reshape(b, g, r, d).float().numpy(),
                               rtol=2e-2, atol=2e-2)
