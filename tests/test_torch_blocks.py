"""Whole blocks of the five paper programs through the port's SM pipeline
against the JAX package, bit for bit (gmem, written mask, every counter),
under the baseline, 32-SP and depth-2 warp-stack variants.  JAX runs its
``"jnp"`` backend; the port its default ``"cuda_fused"`` (whose CPU path
is the plain staged pipeline) and, on the baseline, ``"torch"``."""
import numpy as np
import pytest

from repro_torch.core.programs import ALL
from test_torch_parity import CONFIGS, assert_same, jax_block, port_block


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(ALL))
def test_paper_program_block(name, cfg_name):
    mod = ALL[name]
    n = 32
    code = mod.build(n)
    g0 = mod.make_gmem(np.random.default_rng(0), n)
    grid, bd = mod.launch(n)
    kw = CONFIGS[cfg_name]
    want = jax_block(code, bd, grid, g0, **kw)
    assert_same(want, port_block(code, bd, grid, g0, **kw),
                f"{name}/{cfg_name}")
    if cfg_name == "baseline":
        assert_same(want, port_block(code, bd, grid, g0, "torch"),
                    f"{name}/torch")
