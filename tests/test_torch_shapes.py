"""Port parity: ``repro_torch.launch.shapes.decode_specs`` against
``repro.launch.shapes.decode_specs`` for every full config and every
decode shape that ``applicability`` admits.

The reference traces ``lm.prefill`` with ``jax.eval_shape``; the port runs
its ``lm.prefill`` on fake tensors (no allocation). The decode tokens and
every leaf of the cache tree must have the reference's path, shape and
dtype. These are the largest shapes of the repo (Nemotron-4-340B's and
Grok-1's caches at 128 x 32768), so a leak of real allocation would show
as an out-of-memory error here.
"""

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

CASES = [(arch, name) for arch in ARCHS
         for name, shape in tshapes.SHAPES.items()
         if shape.kind == "decode"
         and tshapes.applicability(tget_config(arch), shape) is None]


def _ref_leaves(tree) -> dict:
    return {tuple(str(p.key) for p in path): (tuple(leaf.shape),
                                             str(jnp.dtype(leaf.dtype)))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    return {path: (tuple(leaf.shape), str(leaf.dtype).split(".")[-1])
            for path, leaf in tree_items(tree)}


def test_cases_cover_the_matrix():
    """decode_32k for all 11 configs, long_500k for the sub-quadratic
    ones (Jamba, xLSTM)."""
    assert len(CASES) == 13
    assert sorted(a for a, n in CASES if n == "long_500k") == [
        "jamba_1_5_large_398b", "xlstm_125m"]


@pytest.mark.parametrize("arch,shape_name", CASES)
def test_decode_specs_equal(arch, shape_name):
    jtok, jcache = jshapes.decode_specs(jget_config(arch),
                                        jshapes.SHAPES[shape_name])
    ttok, tcache = tshapes.decode_specs(tget_config(arch),
                                        tshapes.SHAPES[shape_name])
    assert tuple(ttok.shape) == tuple(jtok.shape)
    assert ttok.dtype == torch.int32 and ttok.device.type == "meta"
    assert _port_leaves(tcache) == _ref_leaves(jcache)
    assert all(leaf.device.type == "meta" for _, leaf in tree_items(tcache))
