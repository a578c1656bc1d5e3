"""The flash kernels at dh 224 on the card (Zamba2-7B's shared attention,
32 heads of 224, scores scaled by (224 / 2) ** -0.5): the tensor-core
forward and backward against the plain versions (``mha_lse_ref``,
``mha_bwd_ref``) and against the forced SIMT kernels, at the custom
scale; the rule picks ``"tc"``.  The widths the other tests cover (64,
128, 256) are unchanged (``tests/test_torch_cuda.py``).

Marked ``cuda``: without a CUDA device every test here skips.  On a host
with the card and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_dh224.py
"""
import pytest
import torch

from repro_torch.kernels import _build, flash_attention as tfa
from repro_torch.kernels.ref import mha_bwd_ref, mha_lse_ref

pytestmark = pytest.mark.cuda

SCALE = (224 / 2) ** -0.5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(card, B, S, H, KH, seed=0):
    g = torch.Generator(device=card).manual_seed(seed + S)
    q = torch.randn((B, S, H, 224), generator=g, device=card).bfloat16()
    k, v = (torch.randn((B, S, KH, 224), generator=g, device=card)
            .bfloat16() for _ in range(2))
    do = torch.randn((B, S, H, 224), generator=g, device=card).bfloat16()
    return q, k, v, do


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * float(want.float().abs().max()))


def test_rule_picks_tensor_cores_at_224(card):
    q, k, v, _ = _inputs(card, 1, 64, 2, 2)
    assert 224 in tfa.TC_HEAD_DIMS and tfa.variant(q, k, v) == "tc"
    assert tfa.bwd_split(2, 32, 32, 4096, 224, 132) == 1


# (B, S, H, KH): a ragged causal shape with GQA, and the cell's call
@pytest.mark.parametrize("B,S,H,KH", [(2, 200, 4, 2), (2, 4096, 32, 32)])
def test_dh224_forward_and_backward_match(card, B, S, H, KH):
    """``"tc"`` forward (o and lse) and backward (dq, dk, dv) against the
    plain versions on the first four query heads (2e-2 of each
    gradient's largest magnitude, 3e-2 for o, 1e-4 for lse) and against
    the forced SIMT kernels; two backward calls give equal bits."""
    q, k, v, do = _inputs(card, B, S, H, KH)
    _build.VARIANTS.clear()
    o, lse = tfa._launch(q, k, v, True, None, want_lse=True, scale=SCALE)
    os_, lses = tfa._launch(q, k, v, True, "simt", want_lse=True,
                            scale=SCALE)
    got = tfa.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                  scale=SCALE)
    again = tfa.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                    scale=SCALE)
    simt = tfa.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                   scale=SCALE, variant="simt")
    torch.cuda.synchronize()
    assert dict(_build.VARIANTS) == {
        ("flash_attention", "tc"): 1, ("flash_attention", "simt"): 1,
        ("flash_attention_bwd", "tc"): 2, ("flash_attention_bwd", "simt"): 1}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    hq = slice(0, min(H, 4))
    hk = slice(0, max(1, (min(H, 4) * KH) // H))
    qs, ks, vs = q[:, :, hq], k[:, :, hk], v[:, :, hk]
    wo, wl = mha_lse_ref(qs, ks, vs, causal=True, scale=SCALE)
    _close(o[:, :, hq], wo, 3e-2)
    _close(os_[:, :, hq], wo, 3e-2)
    torch.testing.assert_close(lse[:, hq], wl, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lses[:, hq], wl, rtol=1e-4, atol=1e-4)
    want = mha_bwd_ref(qs, ks, vs, o[:, :, hq], do[:, :, hq], lse[:, hq],
                       causal=True, scale=SCALE)
    for a, s, w, sl in zip(got, simt, want, (hq, hk, hk)):
        _close(a[:, :, sl], w, 2e-2)
        _close(s[:, :, sl], w, 2e-2)


def test_dh224_function_under_autograd(card):
    """``ops.mha`` at dh 224 with the scale under autograd: one
    ``"tc"`` forward and one ``"tc"`` backward, the gradient of q the
    plain version's."""
    from repro_torch.kernels import ops
    q, k, v, do = _inputs(card, 1, 256, 4, 4, seed=5)
    x = q.detach().requires_grad_(True)
    _build.VARIANTS.clear()
    got = torch.autograd.grad(ops.mha(x, k, v, scale=SCALE), x, do)[0]
    assert dict(_build.VARIANTS) == {("flash_attention", "tc"): 1,
                                     ("flash_attention_bwd", "tc"): 1}
    o, lse = mha_lse_ref(q, k, v, causal=True, scale=SCALE)
    want = mha_bwd_ref(q, k, v, o, do, lse, causal=True, scale=SCALE)[0]
    _close(got, want, 2e-2)
