"""The port's kernel-variant rules, on the CPU.

Flash attention and matmul each come in variants on the card (the
tensor-core and SIMT flash kernels; matmul's float32 and bfloat16 kernels,
each with a scalar-load form for rows that are not whole 16-byte vectors).
A pure function of dtypes, shapes, pointers and strides picks one; these
tests pin that rule.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``): CPU tensors take the
plain versions whatever the variant, and count no launch.  Also here: the
parameter carrier ``convert.from_numpy`` defaults to the card like every
entry point of the port.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels.ref import (flash_attention_ref, mha_bwd_ref,
                                    mha_lse_ref, mha_ref)
from repro_torch.models import convert


def qkv(B=2, S=64, H=8, KH=4, dh=128, dtype=torch.bfloat16, T=None):
    """q (B, S, H, dh) and k/v the first S rows of a (B, T, KH, dh) cache."""
    g = torch.Generator().manual_seed(0)
    T = T or S
    q = torch.randn((B, S, H, dh), generator=g).to(dtype)
    ck, cv = (torch.randn((B, T, KH, dh), generator=g).to(dtype)
              for _ in range(2))
    return q, ck[:, :S], cv[:, :S]


def misaligned(shape, dtype):
    """A contiguous tensor one element past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("dh", [64, 128, 256])
def test_flash_bf16_contiguous_takes_tc(dh):
    assert tfa.variant(*qkv(dh=dh)) == "tc"


def test_flash_bf16_cache_prefix_takes_tc():
    """The prefill's call: k/v are ``ck[:, :S]`` of a longer cache, read
    in place; its strides are whole 16-byte rows."""
    q, k, v = qkv(S=200, T=232)
    assert not k.is_contiguous()
    assert tfa.variant(q, k, v) == "tc"


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 128),
                                      (torch.float32, 64),
                                      (torch.bfloat16, 40),
                                      (torch.bfloat16, 16)])
def test_flash_other_dtypes_and_widths_take_simt(dtype, dh):
    assert tfa.variant(*qkv(dh=dh, dtype=dtype)) == "simt"


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_misaligned_pointer_takes_simt(which):
    x = list(qkv())
    x[which] = misaligned(x[which].shape, torch.bfloat16)
    assert x[which].data_ptr() % 16
    assert tfa.variant(*x) == "simt"


def test_flash_stride_off_the_vector_takes_simt():
    """Rows 8-aligned in the pointer but a sequence stride of 129
    elements: not every row starts on a 16-byte boundary."""
    q, k, v = qkv()
    wide = torch.zeros((2, 64, 4, 129), dtype=torch.bfloat16)
    k = wide[..., :128]
    assert k.data_ptr() % 16 == 0 and k.stride(2) % 8
    assert tfa.variant(q, k, v) == "simt"


@pytest.mark.parametrize("forced", [None, "simt"])
def test_flash_on_cpu_takes_the_plain_version(forced):
    """CPU tensors take the plain version whatever the variant, and no
    launch is counted."""
    q, k, v = qkv(S=64)
    _build.LAUNCHES.clear()
    _build.VARIANTS.clear()
    got = tfa.flash_attention_gqa(q, k, v, causal=True, variant=forced)
    torch.testing.assert_close(got, mha_ref(q, k, v, causal=True))
    q3, k3, v3 = (x.transpose(1, 2).reshape(-1, 64, 128)[:4].contiguous()
                  for x in (q, k, v))
    got = tfa.flash_attention(q3, k3, v3, causal=True, variant=forced)
    torch.testing.assert_close(got, flash_attention_ref(q3, k3, v3))
    assert not _build.LAUNCHES and not _build.VARIANTS


@pytest.mark.parametrize("forced", ["tc", "wgmma"])
def test_flash_forces_only_the_simt_variant(forced):
    """The rule alone picks the tensor-core variant; a caller may only
    force the SIMT one."""
    with pytest.raises(ValueError, match="variant"):
        tfa.flash_attention_gqa(*qkv(), variant=forced)


def bwd_inputs(dh=128, dtype=torch.bfloat16, S=64, T=None):
    """q, k, v as :func:`qkv`, and o and dO of q's shape and dtype."""
    q, k, v = qkv(S=S, dh=dh, dtype=dtype, T=T)
    g = torch.Generator().manual_seed(1)
    o, do = (torch.randn(q.shape, generator=g).to(dtype) for _ in range(2))
    return q, k, v, o, do


@pytest.mark.parametrize("dh,T", [(64, None), (128, None), (64, 232),
                                  (128, 232)])
def test_flash_bwd_bf16_takes_tc(dh, T):
    """The backward's rule over q, k, v, o and dO: bf16 at dh 64 or 128,
    contiguous or k/v a cache prefix, takes the tensor-core kernels."""
    x = bwd_inputs(dh=dh, S=200 if T else 64, T=T)
    assert T is None or not x[1].is_contiguous()
    assert tfa.variant(*x) == "tc"


def _odd_do_stride(x):
    """dO whose head stride (129 elements) is off the 16-byte vector."""
    q = x[0]
    wide = torch.zeros(q.shape[:-1] + (q.shape[-1] + 1,), dtype=q.dtype)
    do = wide[..., :q.shape[-1]]
    assert do.data_ptr() % 16 == 0 and do.stride(2) % 8
    return x[:4] + [do]


@pytest.mark.parametrize("case", ["float32", "dh 16", "dh 32",
                                  "misaligned o", "misaligned dO",
                                  "odd dO stride"])
def test_flash_bwd_other_inputs_take_simt(case):
    """float32 (the tensor cores would round it to TF32), dh 16 or 32,
    and an o or dO whose rows are not whole 16-byte copies take the SIMT
    kernels."""
    if case == "float32":
        x = list(bwd_inputs(dtype=torch.float32))
    elif case.startswith("dh"):
        x = list(bwd_inputs(dh=int(case[3:])))
    else:
        x = list(bwd_inputs())
    if case == "misaligned o":
        x[3] = misaligned(x[3].shape, torch.bfloat16)
        assert x[3].data_ptr() % 16
    elif case == "misaligned dO":
        x[4] = misaligned(x[4].shape, torch.bfloat16)
        assert x[4].data_ptr() % 16
    elif case == "odd dO stride":
        x = _odd_do_stride(x)
    assert tfa.variant(*x[:3]) == ("tc" if case in ("misaligned o",
                                                    "misaligned dO",
                                                    "odd dO stride")
                                   else "simt")
    assert tfa.variant(*x) == "simt"


def test_flash_bwd_dh_256_takes_tc():
    """The backward takes every head width the forward takes; at dh 256
    (paligemma's) the rule gives bf16 the tensor-core kernels of that
    width, as it gives the forward."""
    assert tfa.MAX_BWD_HEAD_DIM == tfa.MAX_HEAD_DIM == 256
    assert tfa.variant(*bwd_inputs(dh=256)) == "tc"


@pytest.mark.parametrize("case", ["float32", "misaligned q", "misaligned o",
                                  "misaligned dO"])
def test_flash_dh_256_other_inputs_take_simt(case):
    """At dh 256 as at 64 and 128: float32 (the tensor cores would round
    it to TF32) and a q, o or dO one element past a 16-byte boundary take
    the SIMT kernels, forward (over q, k, v) and backward (over q, k, v,
    o, dO)."""
    x = list(bwd_inputs(dh=256, dtype=torch.float32 if case == "float32"
                        else torch.bfloat16))
    which = {"misaligned q": 0, "misaligned o": 3,
             "misaligned dO": 4}.get(case)
    if which is not None:
        x[which] = misaligned(x[which].shape, torch.bfloat16)
        assert x[which].data_ptr() % 16
    assert tfa.variant(*x[:3]) == ("tc" if case in ("misaligned o",
                                                    "misaligned dO")
                                   else "simt")
    assert tfa.variant(*x) == "simt"


def test_flash_dh_256_cache_prefix_takes_tc():
    """paligemma's prefill reads k/v as ``ck[:, :S]`` of a longer cache:
    at dh 256 its rows are whole 16-byte copies too, so the forward and
    the backward both take the tensor-core kernels."""
    q, k, v = qkv(S=200, T=232, dh=256)
    assert not k.is_contiguous()
    assert tfa.variant(q, k, v) == "tc"
    assert tfa.variant(*bwd_inputs(dh=256, S=200, T=232)) == "tc"


@pytest.mark.parametrize("shape,n_sm,want", [
    ((8, 8, 1, 512, 256), 132, 4),     # paligemma's training call
    ((2, 8, 4, 256, 256), 132, 2),     # no divisor reaches 132: all 2
    ((8, 32, 16, 512, 256), 132, 1),   # 1024 CTAs without a split
    ((8, 12, 1, 512, 256), 132, 3),    # 3 divides 12; 2 gives only 128
    ((8, 8, 1, 512, 128), 132, 1),     # other widths are never split
    ((8, 8, 1, 512, 256), 16, 1)])
def test_flash_bwd_split_rule(shape, n_sm, want):
    """``bwd_split``: the smallest divisor of the GQA group whose dK/dV
    CTAs (KV heads x batch x 64-key tiles x the divisor) outnumber the
    card's SMs, else the whole group; 1 below dh 256."""
    B, H, KH, Sk, dh = shape
    assert tfa.bwd_split(B, H, KH, Sk, dh, n_sm) == want


def test_mha_dh_256_differentiates_through_the_flash_function():
    """``ops.mha`` at dh 256 under autograd goes through
    ``FlashAttention`` (its forward saved with the lse, its backward
    ``flash_attention_bwd``), and on the CPU its gradients are
    ``mha_bwd_ref``'s on the same q, k, v, o, dO and lse."""
    from repro_torch.kernels import ops
    q, k, v = (x.float().requires_grad_(True)
               for x in qkv(S=64, H=4, KH=2, dh=256))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    out = ops.mha(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (q, k, v), do)
    o, lse = mha_lse_ref(q.detach(), k.detach(), v.detach(), causal=True)
    want = mha_bwd_ref(q.detach(), k.detach(), v.detach(), o, do, lse,
                       causal=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("forced", ["tc", "wgmma"])
def test_flash_bwd_forces_only_the_simt_variant(forced):
    q, k, v, o, do = bwd_inputs()
    lse = torch.zeros((2, 8, 64))
    with pytest.raises(ValueError, match="variant"):
        tfa.flash_attention_bwd(q, k, v, o, do, lse, variant=forced)


@pytest.mark.parametrize("forced", [None, "simt"])
def test_flash_bwd_on_cpu_takes_the_plain_version(forced):
    """CPU tensors take ``mha_bwd_ref`` whatever the variant, and no
    launch is counted."""
    q, k, v = qkv(S=64)
    _, lse = mha_lse_ref(q, k, v, causal=True)
    o = mha_ref(q, k, v, causal=True)
    do = bwd_inputs()[4]
    _build.LAUNCHES.clear()
    _build.VARIANTS.clear()
    got = tfa.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                  variant=forced)
    want = mha_bwd_ref(q, k, v, o, do, lse, causal=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not _build.LAUNCHES and not _build.VARIANTS


@pytest.mark.parametrize("forced", [None, "simt"])
def test_flash_function_passes_the_forced_variant_to_backward(monkeypatch,
                                                              forced):
    """``FlashAttention.backward`` hands the forward's forced variant to
    :func:`flash_attention_bwd`, so a caller that forces the SIMT forward
    gets the SIMT backward too."""
    seen = []
    bwd = tfa.flash_attention_bwd

    def spy(*a, **kw):
        seen.append(kw["variant"])
        return bwd(*a, **kw)

    monkeypatch.setattr(tfa, "flash_attention_bwd", spy)
    q, k, v = (x.clone().requires_grad_(True) for x in qkv(S=64))
    out = tfa.flash_attention_gqa(q, k, v, causal=True, variant=forced)
    out.float().sum().backward()
    assert seen == [forced]
    assert all(x.grad is not None for x in (q, k, v))


@pytest.mark.parametrize("dtype,want", [(torch.float32, "simt"),
                                        (torch.bfloat16, "tc")])
@pytest.mark.parametrize("shape", [(512, 512, 512), (200, 200, 200),
                                   (128, 384, 256)])
def test_matmul_vector_variants(dtype, want, shape):
    """Whole 16-byte rows: the dtype's kernel with vector copies; 200^3 is
    ragged against the 64 x 32 tiles (the kernel masks it) and the block
    rule admits it with the default blocks."""
    M, K, N = shape
    a, b = torch.ones((M, K), dtype=dtype), torch.ones((K, N), dtype=dtype)
    assert tmm.variant(a, b) == want
    assert torch.equal(tmm.matmul(a, b), torch.full((M, N), float(K),
                                                    dtype=dtype))


@pytest.mark.parametrize("dtype,K,N,want", [
    (torch.float32, 100, 50, "simt_scalar"),   # N % 4
    (torch.float32, 50, 100, "simt"),          # A goes by 4-byte copies
    (torch.bfloat16, 100, 64, "tc_scalar"),    # K % 8
    (torch.bfloat16, 64, 100, "tc_scalar"),    # N % 8
    (torch.bfloat16, 64, 64, "tc")])
def test_matmul_ragged_rows_take_scalar_loads(dtype, K, N, want):
    """Shapes the block rule admits (clipped blocks divide every dim)
    whose rows are not whole 16-byte vectors."""
    M = 300
    g = torch.Generator().manual_seed(K + N)
    a = torch.randn((M, K), generator=g).to(dtype)
    b = torch.randn((K, N), generator=g).to(dtype)
    assert tmm.variant(a, b) == want
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(tmm.matmul(a, b).float(),
                               (a.float() @ b.float()).to(dtype).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_misaligned_pointer_takes_scalar_loads(dtype):
    a = torch.ones((64, 64), dtype=dtype)
    b = misaligned((64, 64), dtype)
    assert tmm.variant(a, b).endswith("_scalar")
    if dtype == torch.bfloat16:
        assert tmm.variant(misaligned((64, 64), dtype),
                           torch.ones((64, 64), dtype=dtype)) == "tc_scalar"
    else:   # float32 copies A by 4-byte copies: its alignment is free
        assert tmm.variant(misaligned((64, 64), dtype),
                           torch.ones((64, 64), dtype=dtype)) == "simt"


def test_from_numpy_defaults_to_the_card(monkeypatch):
    tree = {"w": np.ones((2, 3), np.float32), "layers": (np.arange(4),)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_numpy(tree)
    got = convert.from_numpy(tree, device="cpu")
    assert got["w"].device.type == "cpu" and got["w"].dtype == torch.float32
    assert isinstance(got["layers"], tuple)
    assert torch.equal(got["layers"][0], torch.arange(4))


@pytest.mark.parametrize("Sq,want", [(9, "flash"), (512, "flash"),
                                     (8, "plain"), (1, "plain")])
def test_full_attention_routes_by_query_length(monkeypatch, Sq, want):
    """``layers.full_attention`` (the encoder-decoder's encoder and cross
    attention) sends Sq > 8 to ``flash_attention_gqa(causal=False)``
    whatever Sk (no ``tile_ok``: Sk 75 is ragged), and a decode step's
    queries to the plain ``causal_attention(causal=False)``.  The choice
    reads the query length alone, so a CUDA tensor takes the same branch,
    where the wrapper launches the kernel."""
    from repro_torch.models import layers as tL
    seen = []
    real = tfa.flash_attention_gqa

    def spy(q, k, v, *, causal=True, variant=None):
        seen.append(causal)
        return real(q, k, v, causal=causal, variant=variant)

    monkeypatch.setattr(tfa, "flash_attention_gqa", spy)
    q = torch.randn((2, Sq, 4, 64), generator=torch.Generator()
                    .manual_seed(Sq)).bfloat16()
    k, v = (torch.randn((2, 75, 2, 64), generator=torch.Generator()
                        .manual_seed(s)).bfloat16() for s in (1, 2))
    got = tL.full_attention(q, k, v)
    assert seen == ([False] if want == "flash" else [])
    if want == "plain":
        assert torch.equal(got, tL.causal_attention(q, k, v, causal=False))
    else:
        assert torch.equal(got, mha_ref(q, k, v, causal=False))


def test_whisper_encoder_shape_takes_tc():
    """whisper-medium's encoder call, (4, 1500, 16, 64) bf16 with 16 KV
    heads, and its cross-attention (512 queries against the 1500 frames):
    the rule gives the tensor-core kernel, ragged last tile and all."""
    q = torch.zeros((4, 1500, 16, 64), dtype=torch.bfloat16)
    assert tfa.variant(q, q, q) == "tc"
    qx = torch.zeros((4, 512, 16, 64), dtype=torch.bfloat16)
    assert tfa.variant(qx, q, q) == "tc"
    assert tfa.variant(*(x.transpose(1, 2).contiguous().transpose(1, 2)
                         for x in (q, q, q))) == "tc"


def test_full_attention_differentiates_through_the_flash_function():
    """``layers.full_attention`` at Sq 40, Sk 75 under autograd goes
    through ``FlashAttention`` without a mask, and on the CPU its
    gradients are ``mha_bwd_ref``'s on the same q, k, v, o, dO and lse."""
    from repro_torch.models import layers as tL
    g = torch.Generator().manual_seed(4)
    q = torch.randn((2, 40, 4, 64), generator=g).requires_grad_(True)
    k, v = (torch.randn((2, 75, 2, 64), generator=g).requires_grad_(True)
            for _ in range(2))
    do = torch.randn((2, 40, 4, 64), generator=g)
    out = tL.full_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (q, k, v), do)
    o, lse = mha_lse_ref(q.detach(), k.detach(), v.detach(), causal=False)
    want = mha_bwd_ref(q.detach(), k.detach(), v.detach(), o, do, lse,
                       causal=False)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
