"""The port's published Zamba2 block (``models.hybrid.Zamba2Config``,
``configs`` zamba2-7b-instruct) against the benchmark's plain fp32
reference (``perfbench/reference/zamba2_lm.py``), and that reference
against ``transformers``' ``Zamba2ForCausalLM`` (eager attention, fp32).

Tiny widths: d 64, 6 layers, hybrid layers 2 and 5 calling blocks 0 and
1, 2 groups, chunk 8, 4 attention heads of 32 (2 d / heads, as
published), adapters of rank 8.  Tolerances: the reference and
``transformers`` in fp32 agree to round-off (2e-5 of the logits' largest
magnitude); the program computing in fp32 (``COMPUTE_DTYPE`` and the
parameters patched, as ``tests/test_torch_ssm.py`` does) agrees with the
reference to 2e-4 in the loss and logits and to 1e-3 of each gradient
leaf's largest magnitude (the SSD's sums run in another order); the
program as it runs, in bf16, lies within a relative Frobenius error of
0.05 of the reference's logits.
"""
import dataclasses
import math
import os
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs, tree as T
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import steps as tsteps
from repro_torch.models import api, hybrid, layers as tL, mamba2
from repro_torch.obs.trace import TRACER
from repro_torch.optim import OptConfig, adamw

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from perfbench.drivers.hybrid_train import make_weights  # noqa: E402
from perfbench.reference import zamba2_lm as R  # noqa: E402

SPEC = configs.reduced(configs.get("zamba2-7b-instruct"))


def ref_cfg(spec=SPEC) -> dict:
    """The reference's configuration (published keys) of a program's
    ``Zamba2Config``."""
    c = spec.cfg
    return {
        "hidden_size": c.d_model, "num_hidden_layers": c.n_layers,
        "vocab_size": c.vocab, "num_attention_heads": c.n_heads,
        "num_key_value_heads": c.n_kv, "attention_head_dim": c.head_dim,
        "attention_hidden_size": 2 * c.d_model,
        "intermediate_size": c.d_ff, "adapter_rank": c.adapter_rank,
        "hybrid_layer_ids": list(c.hybrid_layer_ids),
        "num_mem_blocks": c.num_mem_blocks, "mamba_d_state": c.d_state,
        "mamba_d_conv": c.conv_width, "mamba_expand": c.expand,
        "mamba_headdim": c.mamba_head_dim, "mamba_ngroups": c.n_groups,
        "n_mamba_heads": c.expand * c.d_model // c.mamba_head_dim,
        "chunk_size": c.chunk, "rope_theta": c.rope_theta,
        "rms_norm_eps": c.norm_eps, "time_step_min": c.dt_min,
        "time_step_max": 0.1, "time_step_floor": 1e-4,
        "model_type": "zamba2", "loss": {"z_loss": 1e-4},
        "optimizer": {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                      "weight_decay": 0.1, "clip_norm": 1.0, "warmup": 100},
        "init": {"std": 0.02, "zeros": ["conv_b"],
                 "ones": ["ln", "gate_norm", "ln1", "ln2", "final_norm",
                          "D_skip"]},
    }


def weights(seed=0, spec=SPEC, std=0.1):
    """The benchmark's weights at the tiny size (a larger spread than the
    cell's 0.02, so that every path moves the logits)."""
    cfg = dict(ref_cfg(spec), init=dict(ref_cfg(spec)["init"], std=std))
    return make_weights(spec, cfg, seed, torch.device("cpu"))


def tokens(b=2, s=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, SPEC.cfg.vocab, (b, s + 1), generator=g)


def f32_tree(params):
    return T.tree_map(lambda p: p.detach().float(), params)


def ref_leaves(params):
    return {n: t.detach().float() for n, t in R.flatten(params).items()}


# -------------------------------------------------- configuration and tree
def test_config_is_the_published_stage():
    """The catalog's widths, cut to layers 0-23: hybrid layers 6, 11, 17,
    23 on blocks 0, 1, 0, 1; kept out of ``ARCH_IDS`` (the JAX package's
    list) and found by ``configs.get``."""
    c = configs.get("zamba2-7b-instruct").cfg
    assert (c.n_layers, c.d_model, c.vocab, c.n_heads, c.n_kv, c.head_dim,
            c.d_ff) == (24, 3584, 32000, 32, 32, 224, 14336)
    assert c.hybrid_layer_ids == (6, 11, 17, 23) and c.n_calls == 4
    assert [i % c.num_mem_blocks for i in range(c.n_calls)] == [0, 1, 0, 1]
    assert (c.d_state, c.mamba_head_dim, c.n_groups, c.expand, c.conv_width,
            c.chunk, c.adapter_rank, c.num_mem_blocks) == \
        (64, 64, 2, 2, 4, 256, 128, 2)
    assert c.mamba.n_heads == 112 and c.attn.scale == (224 / 2) ** -0.5
    assert c.layers_block_type.count("hybrid") == 4
    assert "zamba2_7b_instruct" not in configs.ARCH_IDS
    assert round(c.param_count() / 1e9, 3) == 2.733


def test_tree_shapes_and_param_count():
    c = SPEC.cfg
    p = api.param_shapes(SPEC)
    assert sum(x.numel() for x in T.leaves(p)) == c.param_count()
    assert tuple(p["blocks"]["attn"]["wq"].shape) == (2, 128, 128)
    assert tuple(p["blocks"]["attn"]["wo"].shape) == (2, 128, 64)
    assert tuple(p["calls"]["lora_b"].shape) == (2, 8, 192)
    assert p["layers"]["A_log"].dtype == torch.float32
    assert tuple(p["layers"]["conv_b"].shape) == (6, 128 + 2 * 2 * 16)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-130m"])
def test_other_mamba_configs_keep_their_block(arch):
    """The new Mamba2 fields default to the JAX package's block: norm
    before the gate over all of d_inner, no conv bias, eps 1e-6, no dt
    clamp; no new leaf."""
    c = configs.get(arch).cfg
    m = c.mamba if hasattr(c, "mamba") else c
    assert (m.norm_before_gate, m.conv_bias, m.norm_eps, m.dt_min) == \
        (True, False, 1e-6, 0.0)
    p = api.param_shapes(configs.reduced(configs.get(arch)))
    assert "conv_b" not in p["layers"] and "blocks" not in p


# ---------------------------------------------------- the plain reference
def test_reference_ssd_matches_sequential_recurrence():
    """The chunked scan against h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t, step by step."""
    g = torch.Generator().manual_seed(3)
    b, S, H, P, N = 2, 24, 4, 8, 6
    x = torch.randn(b, S, H, P, generator=g, dtype=torch.float64)
    dt = torch.rand(b, S, H, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 2
    B, C = (torch.randn(b, S, H, N, generator=g, dtype=torch.float64)
            for _ in range(2))
    got = R.ssd(x, dt, A, B, C, chunk=8)
    h = torch.zeros(b, H, P, N, dtype=torch.float64)
    want = []
    for t in range(S):
        h = h * torch.exp(A * dt[:, t])[..., None, None] + \
            (dt[:, t, :, None, None] * x[:, t, :, :, None] *
             B[:, t, :, None, :])
        want.append(torch.einsum("bhpn,bhn->bhp", h, C[:, t]))
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=1e-10,
                               atol=1e-10)


def _hf_model(cfg: dict, P: dict, chunk: int):
    """``transformers``' Zamba2ForCausalLM (fp32, eager attention, SSD
    chunks of ``chunk``) with the reference's weights."""
    os.environ.setdefault("USE_TF", "0")
    tr = pytest.importorskip("transformers")
    hc = tr.Zamba2Config(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        layers_block_type=["hybrid" if i in cfg["hybrid_layer_ids"]
                           else "mamba"
                           for i in range(cfg["num_hidden_layers"])],
        mamba_d_state=cfg["mamba_d_state"], mamba_d_conv=cfg["mamba_d_conv"],
        mamba_expand=cfg["mamba_expand"],
        mamba_ngroups=cfg["mamba_ngroups"],
        n_mamba_heads=cfg["n_mamba_heads"], chunk_size=chunk,
        intermediate_size=cfg["intermediate_size"], hidden_act="gelu",
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg["num_key_value_heads"],
        num_mem_blocks=cfg["num_mem_blocks"],
        adapter_rank=cfg["adapter_rank"], use_mem_rope=True,
        use_shared_attention_adapter=False,
        rope_theta=cfg["rope_theta"], rms_norm_eps=cfg["rms_norm_eps"],
        time_step_min=cfg["time_step_min"], use_conv_bias=True,
        tie_word_embeddings=True, attn_implementation="eager")
    torch.manual_seed(0)
    model = tr.Zamba2ForCausalLM(hc).float().eval()
    calls = {lid: c for c, lid in enumerate(cfg["hybrid_layer_ids"])}

    def put(param, value):
        assert param.shape == value.shape, (param.shape, value.shape)
        with torch.no_grad():
            param.copy_(value)

    m = model.model
    put(m.embed_tokens.weight, P["embed"])
    put(m.final_layernorm.weight, P["final_norm"])
    for i, layer in enumerate(m.layers):
        mamba = layer.mamba_decoder if i in calls else layer
        mx = mamba.mamba

        def w(name):
            return R.entry(P, f"layers/{name}", i)

        put(mamba.input_layernorm.weight, w("ln"))
        put(mx.in_proj.weight, w("in_proj").t())
        put(mx.conv1d.weight, w("conv_w").t()[:, None, :])
        put(mx.conv1d.bias, w("conv_b"))
        put(mx.dt_bias, w("dt_bias"))
        put(mx.A_log, w("A_log"))
        put(mx.D, w("D_skip"))
        put(mx.norm.weight, w("gate_norm"))
        put(mx.out_proj.weight, w("out_proj").t())
        if i not in calls:
            continue
        c = calls[i]
        b = c % cfg["num_mem_blocks"]
        st = layer.shared_transformer
        assert st.block_id == b

        def bw(name):
            return R.entry(P, f"blocks/{name}", b)

        put(layer.linear.weight, P[f"calls/linear/{c}"].t())
        put(st.input_layernorm.weight, bw("ln1"))
        put(st.pre_ff_layernorm.weight, bw("ln2"))
        for proj in ("q", "k", "v", "o"):
            put(getattr(st.self_attn, f"{proj}_proj").weight,
                bw(f"attn/w{proj}").t())
        ff = st.feed_forward
        put(ff.gate_up_proj.weight, bw("ffn/gate_up").t())
        put(ff.down_proj.weight, bw("ffn/down").t())
        put(ff.gate_up_proj_adapter_list[c][0].weight,
            P[f"calls/lora_a/{c}"].t())
        put(ff.gate_up_proj_adapter_list[c][1].weight,
            P[f"calls/lora_b/{c}"].t())
    assert model.lm_head.weight.data_ptr() == m.embed_tokens.weight.data_ptr()
    return model


def test_reference_logits_match_transformers():
    """The reference's logits equal ``transformers``' Zamba2ForCausalLM's
    (the published equations, eager, fp32) on the same weights, to fp32
    round-off, the reference's SSD over two chunks of 8.  ``transformers``
    4.57's eager Zamba2 scan sums the carried chunk states over the wrong
    axis (``.sum(dim=2)``, the target chunk, where its Mamba2 sums over
    the source), which is right only within one chunk; so it is given one
    chunk of 16, the length of the sequence (the scan's value does not
    depend on the chunk)."""
    cfg = ref_cfg()
    P = ref_leaves(weights())
    tok = tokens()[:, :-1]
    assert tok.shape[1] == 2 * cfg["chunk_size"]
    model = _hf_model(cfg, P, chunk=tok.shape[1])
    with torch.no_grad():
        want = model(input_ids=tok, use_cache=False).logits
    got = R.logits(P, tok, cfg)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5 * scale)


# ---------------------------------------------------- the program's block
def _f32_program(mp):
    mp.setattr(tL, "COMPUTE_DTYPE", torch.float32)


def test_program_matches_reference_loss_logits_and_gradients():
    """Computing in fp32, the program's logits, loss (with its z-loss)
    and every gradient leaf (a stacked leaf by layer, block or call; a
    stacked vector such as ``D_skip`` also each layer's row alone) equal
    the reference's; as it runs (bf16) its logits lie near."""
    cfg = ref_cfg()
    params = weights()
    tok = tokens()
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    P = {n: t.requires_grad_(True) for n, t in ref_leaves(params).items()}
    want_logits = R.logits(P, batch["tokens"], cfg)
    want_loss = R.loss(P, batch["tokens"], batch["labels"], cfg, block=8,
                       rows=8) / batch["tokens"].numel()
    want_grads = dict(zip(P, torch.autograd.grad(want_loss, list(P.values()))))
    bf16_logits = hybrid.forward(params, SPEC.cfg, batch["tokens"])
    err = (bf16_logits - want_logits).norm() / want_logits.norm()
    err = err.detach()
    assert float(err) < 0.05
    with pytest.MonkeyPatch.context() as mp:
        _f32_program(mp)
        p32 = f32_tree(params)
        logits = hybrid.forward(p32, SPEC.cfg, batch["tokens"])
        loss, grads = tsteps.build_loss_and_grads(SPEC)(p32, batch)
    scale = float(want_logits.detach().abs().max())
    torch.testing.assert_close(logits, want_logits.detach(), rtol=0,
                               atol=2e-4 * scale)
    assert abs(float(loss) - float(want_loss)) < 2e-4 * float(want_loss)
    got = R.flatten(grads)
    assert sorted(got) == sorted(want_grads)
    for name, w in want_grads.items():
        g = got[name]
        assert float(w.abs().max()) > 0, name
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-3 * float(w.abs().max()),
                                   msg=name)
        if name.split("/")[0] in R.STACKED and \
                not name.split("/")[-1].isdigit():
            # a stacked leaf of one vector a layer (D_skip): each layer's
            # row alone, against its own largest magnitude
            for i, (a, b) in enumerate(zip(g, w)):
                torch.testing.assert_close(
                    a, b, rtol=0, atol=1e-3 * float(b.abs().max()),
                    msg=f"{name}/{i}")


def test_tied_block_gradient_is_the_sum_over_its_calls():
    """With one shared block called at both hybrid layers, its gradient
    equals the sum of the two blocks' gradients when each call has a
    copy of its own (same weights)."""
    tied = dataclasses.replace(SPEC, cfg=dataclasses.replace(
        SPEC.cfg, num_mem_blocks=1))
    p1 = f32_tree(weights(spec=tied))
    p2 = dict(p1, blocks=T.tree_map(lambda x: torch.cat([x, x]),
                                    p1["blocks"]))
    tok = tokens(b=1)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    with pytest.MonkeyPatch.context() as mp:
        _f32_program(mp)
        _, g1 = tsteps.build_loss_and_grads(tied)(p1, batch)
        _, g2 = tsteps.build_loss_and_grads(SPEC)(p2, batch)
    for (path, a), (_, b) in zip(T.leaves_with_paths(g1["blocks"]),
                                 T.leaves_with_paths(g2["blocks"])):
        torch.testing.assert_close(a[0], b[0] + b[1], rtol=1e-5,
                                   atol=1e-6 * float(a.abs().max()),
                                   msg=str(path))
        assert float(b[0].abs().max()) > 0 and float(b[1].abs().max()) > 0


def test_prefill_then_decode_match_the_reference():
    """Prefill of 8 tokens, then 4 decode steps through
    ``api.apply_decode`` (one KV cache a call, the Mamba2 states carried),
    computing in fp32: each step's logits equal the reference's full
    forward at that position."""
    cfg = ref_cfg()
    params = weights(seed=2)
    tok = tokens(s=16, seed=4)[:, :16]
    want = R.logits(ref_leaves(params), tok, cfg)
    with pytest.MonkeyPatch.context() as mp:
        _f32_program(mp)
        p32 = f32_tree(params)
        state = api.decode_state(SPEC, 2, 16, device="cpu")
        assert tuple(state["kv"][0].shape) == (2, 2, 16, 4, 32)
        out, state = api.apply_decode(p32, SPEC, tok[:, :8], state, 0)
        outs = [out]
        for j in range(8, 12):
            out, state = api.apply_decode(p32, SPEC, tok[:, j:j + 1], state,
                                          j)
            outs.append(out)
    got = torch.cat(outs, 1)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want[:, :12], rtol=0, atol=2e-4 * scale)


def test_flash_once_a_call_spans_and_counter(monkeypatch):
    """A training step runs the flash forward and backward once a call at
    the block's scale (the shared blocks outside the remat), and the
    tracer records a ``hybrid.shared-block`` span a call (call and block
    attributes), a ``mamba2.ssd`` span a layer in the forward and again in
    the remat's recompute, and one ``hybrid.forward`` counter sample."""
    seen = []
    fwd = tfa.FlashAttention.forward

    def counted(ctx, q, k, v, causal, variant, scale=None):
        seen.append(("fwd", q.shape[-1], scale))
        return fwd(ctx, q, k, v, causal, variant, scale)

    bwd = tfa.flash_attention_bwd

    def counted_bwd(*a, **kw):
        seen.append(("bwd", a[0].shape[-1], kw.get("scale")))
        return bwd(*a, **kw)

    monkeypatch.setattr(tfa.FlashAttention, "forward", staticmethod(counted))
    monkeypatch.setattr(tfa, "flash_attention_bwd", counted_bwd)
    tok = tokens(b=1)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    TRACER.start()
    try:
        tsteps.build_loss_and_grads(SPEC)(weights(), batch)
    finally:
        TRACER.stop()
    s = (32 / 2) ** -0.5
    assert sorted(seen) == [("bwd", 32, s)] * 2 + [("fwd", 32, s)] * 2
    blocks = TRACER.find("hybrid.shared-block")
    assert sorted((b.attrs["call"], b.attrs["block"]) for b in blocks) == \
        [(0, 0), (1, 1)]
    ssd = TRACER.find("mamba2.ssd")
    assert len(ssd) == 2 * SPEC.cfg.n_layers
    assert all(sp.attrs["chunks"] == 2 for sp in ssd)
    assert TRACER.counter_samples("hybrid.forward") == \
        [{"shared_block_calls": 2, "ssd_chunks": 12}]


def test_make_weights_follows_the_published_init():
    """``A_log`` log(1..H) in fp32, ``dt_bias`` the inverse softplus of dt
    in [time_step_min, time_step_max], ``D_skip`` and norms 1, the conv
    bias 0; the rest drawn in its leaf's dtype."""
    p = weights()
    lay = p["layers"]
    H = SPEC.cfg.mamba.n_heads
    assert lay["A_log"].dtype == torch.float32
    torch.testing.assert_close(lay["A_log"][3], torch.log(
        torch.arange(1, H + 1, dtype=torch.float32)))
    dt = torch.nn.functional.softplus(lay["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1
    assert bool((lay["D_skip"] == 1).all() and (lay["conv_b"] == 0).all())
    assert bool((p["blocks"]["ln1"] == 1).all())
    assert lay["in_proj"].dtype == torch.bfloat16
    assert 0.05 < float(lay["in_proj"].float().std()) < 0.15
    assert math.isfinite(float(mamba2.softplus(lay["dt_bias"]).sum()))


@pytest.mark.parametrize("donate", [False, True])
def test_big_leaf_update_is_sliced_and_bit_equal(monkeypatch, donate):
    """AdamW updates a leaf above ``adamw.SLICE_NUMEL`` elements whose
    entries hold at least ``MIN_SLICE_NUMEL`` an entry of its leading axis
    at a time (Zamba2-7B's stacked in_proj): every parameter, m and v
    bit-equal to the whole-leaf update."""
    g = torch.Generator().manual_seed(7)

    def tree():
        return {"layers": {"w": torch.randn(6, 8, 16, generator=g)
                           .bfloat16()},
                "v": torch.randn(16, generator=g).bfloat16()}

    params, grads = tree(), tree()
    cfg = OptConfig()
    state = adamw.init(params, cfg)
    state = dict(state, m=T.tree_map(lambda p: torch.randn(
        p.shape, generator=g) * 1e-3, params))
    copy = T.tree_map(torch.clone, {"p": params, "s": state})
    want = adamw.step(copy["p"], copy["s"], grads, cfg)
    monkeypatch.setattr(adamw, "SLICE_NUMEL", 100)
    monkeypatch.setattr(adamw, "MIN_SLICE_NUMEL", 128)
    assert adamw._sliced(params["layers"]["w"], state["v"]["layers"]["w"])
    got = adamw.step(params, state, grads, cfg, donate=donate)
    for a, b in zip(T.leaves(got[:2]), T.leaves(want[:2])):
        assert torch.equal(a, b)


# ------------------------------------------------- the benchmark's check
CELL, SEED = "zamba2-7b-instruct.train-2x4096", 2 ** 31 + 311


@pytest.fixture
def tiny_cell(monkeypatch):
    """The benchmark cell on the CPU at this file's widths, 2 x 64
    tokens, with its own limits."""
    from perfbench import harness as H
    from perfbench.drivers import lm_train
    monkeypatch.setattr(H, "DEVICE", "cpu")
    monkeypatch.setattr(lm_train, "program_spec", lambda cfg: SPEC)
    torch.set_num_threads(4)
    wl = dict(H.workload(CELL), seq=64, pool=4)
    widths = {k: v for k, v in ref_cfg().items()
              if k not in ("init", "optimizer", "loss")}
    return wl, dict(H.config("zamba2-7b-instruct"), **widths)


def test_check_compares_the_first_gradient_elementwise(tiny_cell):
    """Set-up keeps the program's first gradient (the optimizer's m after
    one step over 1 - b1) on the host by the reference's leaves, the
    norms the check reads by leaf; the check compares it with the
    reference's elementwise, and the program passes every limit."""
    from perfbench.drivers import hybrid_train
    wl, cfg = tiny_cell
    cell = hybrid_train.Cell(wl, cfg, SEED)
    cell.setup()
    kept = R.leaf_norms(cell.grad1)
    assert sorted(kept) == sorted(cell.program["grad1"])
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in cell.grad1.values())
    for name, n in kept.items():
        assert n == pytest.approx(cell.program["grad1"][name], rel=1e-5)
    cell.release()
    checks = cell.check()
    assert [k for k, _, _ in checks] == list(wl["limits"])
    assert "grad1_elem_gap" in wl["limits"]
    assert all(v <= lim for _, v, lim in checks), checks


def test_controls_fail_the_check_and_bf16_rounding_passes(tiny_cell):
    """Both faults fail at least one of the cell's limits; the program and
    the reference with its products rounded through bf16 (the witness)
    fail none, and the witness reads each layer's one-vector leaves no
    farther than the program does.  The e4m3 control reads
    ``grad1_elem_gap`` at over three times the program's, the separation
    its limit is set in on the card (the limit itself is the card's)."""
    from perfbench.drivers import hybrid_train
    wl, cfg = tiny_cell
    out = hybrid_train.controls(wl, cfg, SEED)
    limits = {k: v["limit"] for k, v in wl["limits"].items()}
    for side in ("program", "witness_bf16", "fault_half_batch",
                 "fault_state_unchanged"):
        got = out[side]
        failed = [k for k, v in limits.items() if got[k] > v]
        assert bool(failed) == side.startswith("fault"), (side, got)
    prog, ctl = out["program"], out["control_fp8"]
    assert ctl["grad1_elem_gap"] > 3 * prog["grad1_elem_gap"]
    assert out["fault_state_unchanged"]["change_leaf_gap"] == 1.0
    assert out["witness_bf16"]["row_elem_gap"] <= prog["row_elem_gap"]


def test_long_leaf_of_short_rows_is_updated_whole():
    """The leaves the slicing is for are Zamba2-7B's stacked in_proj and
    out_proj (entries of 52.7 M and 25.7 M elements); an embedding of
    many short rows above ``SLICE_NUMEL`` (paligemma-3b's 257216 x 2048,
    llama3.2-3b's 128256 x 3072) stays one update, as every other
    configuration's leaves do."""
    def leaf(*shape):
        return torch.empty(shape, device="meta")

    assert adamw._sliced(leaf(24, 3584, 14704), leaf(24, 3584, 14704))
    assert adamw._sliced(leaf(24, 7168, 3584), leaf(24, 7168, 3584))
    for shape in ((257216, 2048), (128256, 3072), (151936, 1024)):
        assert not adamw._sliced(leaf(*shape), leaf(*shape))
