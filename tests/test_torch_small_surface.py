"""The small public surface the port adds beside its sharded steps, held to
the JAX package on the CPU: ``kernels.ops.simt_alu`` (bit for bit against
``repro.kernels.ops.simt_alu``, the Pallas kernel in interpret mode),
``transformer.init_layer`` and ``mamba2.init_layer`` (the JAX functions'
tree, shapes, dtypes, constant leaves and He scales; the random streams of
the two frameworks differ), ``api.input_specs`` (every architecture and
cell: names, shapes and dtypes) and ``configs.all_archs``; and the
steps' ``donate`` without a mesh: the train step's in place and bit-equal
to the new trees it returns otherwise, the serve step's off leaving the
caller's decode state as it was."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import api as japi, mamba2 as jM, transformer as jT
from repro_torch import configs as tconfigs, tree as T
from repro_torch.core import isa
from repro_torch.kernels import ops as tops
from repro_torch.models import api as tapi, mamba2 as tM, transformer as tT

ARCHS = [a for a in jconfigs.ARCH_IDS if a != "flexgrip"]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


@pytest.mark.parametrize("mul,nread", [(True, 3), (False, 2)])
def test_ops_simt_alu_matches_jax(mul, nread):
    rng = np.random.default_rng(7)
    W, L = 8, 32
    ops = [isa.IADD, isa.IMUL, isa.IMAD, isa.ISETP, isa.SHR, isa.SELP,
           isa.S2R, isa.MOV]
    op = np.asarray([ops[i % len(ops)] for i in range(W)], np.int32)
    args = [rng.integers(-2 ** 31, 2 ** 31 - 1, (W, L)).astype(np.int32)
            for _ in range(3)] + \
        [(rng.random((W, L)) > 0.5).astype(np.int32),
         rng.integers(0, 1024, (W, L)).astype(np.int32),
         (rng.random((W, L)) > 0.25).astype(np.int32)]
    want = jops.simt_alu(*(jnp.asarray(x) for x in [op] + args),
                         enable_mul=mul, num_read_operands=nread)
    got = tops.simt_alu(*(torch.as_tensor(x) for x in [op] + args),
                        enable_mul=mul, num_read_operands=nread)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_layer(jtree, ttree):
    """Same paths, shapes and dtypes; norms ones, the fp32 constants equal
    to JAX's; the He-scaled weights within 10% of std sqrt(1 / fan_in)."""
    want = _leaves(jtree)
    got = {"/".join(map(str, p)): t for p, t in T.leaves_with_paths(ttree)}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        t = got[k]
        assert tuple(t.shape) == w.shape and t.dtype == DTYPES[str(w.dtype)]
        w = np.asarray(w, np.float32)
        a = t.float().numpy()
        if np.all(w == w.flat[0]):          # norms, A_log, dt_bias, D_skip
            np.testing.assert_array_equal(a, w, err_msg=k)
        else:
            std = (1.0 / t.shape[-2]) ** 0.5
            assert abs(a.std() / std - 1) < 0.1, k


@pytest.mark.parametrize("arch", ["qwen3_0p6b", "dbrx_132b"])
def test_transformer_init_layer_matches_jax(arch):
    jspec = jconfigs.reduced(jconfigs.get(arch))
    tspec = tconfigs.reduced(tconfigs.get(arch))
    want = jT.init_layer(jax.random.key(0), jspec.cfg)
    got = tT.init_layer(torch.Generator().manual_seed(0), tspec.cfg)
    _check_layer(want, got)
    # the stacked tree's layer 0 has the same leaves
    stacked = tT.init(torch.Generator(), tspec.cfg, device="meta")
    assert {k: tuple(v.shape[1:]) for k, v in
            _flat_port(stacked["layers"]).items()} == \
        {k: tuple(v.shape) for k, v in _flat_port(got).items()}


def test_mamba2_init_layer_matches_jax():
    jspec = jconfigs.reduced(jconfigs.get("mamba2_130m"))
    tspec = tconfigs.reduced(tconfigs.get("mamba2-130m"))
    _check_layer(jM.init_layer(jax.random.key(0), jspec.cfg),
                 tM.init_layer(torch.Generator().manual_seed(0), tspec.cfg))
    # at full width, shapes only
    want = jax.eval_shape(lambda k: jM.init_layer(
        k, jconfigs.get("mamba2_130m").cfg), jax.random.key(0))
    got = tM.init_layer(torch.Generator(), tconfigs.get("mamba2-130m").cfg,
                        device="meta")
    assert {k: tuple(v.shape) for k, v in _flat_port(got).items()} == \
        {k: tuple(v.shape) for k, v in _leaves(want).items()}


def _flat_port(tree):
    return {"/".join(map(str, p)): t for p, t in T.leaves_with_paths(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    jspec, tspec = jconfigs.get(arch), tconfigs.get(arch)
    for shape in jconfigs.SHAPES:
        want = japi.input_specs(jspec, shape)
        got = tapi.input_specs(tspec, shape)
        assert sorted(got) == sorted(want), (arch, shape)
        for k, w in want.items():
            t = got[k]
            assert t.device.type == "meta"
            assert tuple(t.shape) == w.shape, (arch, shape, k)
            assert t.dtype == DTYPES[str(w.dtype)], (arch, shape, k)


def test_all_archs_matches_jax():
    assert [s.name for s in tconfigs.all_archs()] == \
        [s.name for s in jconfigs.all_archs()]
    assert [s.family for s in tconfigs.all_archs()] == \
        [s.family for s in jconfigs.all_archs()]


def _reduced_qwen3():
    spec = tconfigs.reduced(tconfigs.get("qwen3-0.6b"))
    params = tapi.init(torch.Generator().manual_seed(0), spec)
    tok = torch.randint(0, 256, (4, 16),
                        generator=torch.Generator().manual_seed(1))
    return spec, params, tok


def test_train_step_donate_writes_in_place_bit_equal():
    """``donate=True`` writes the update into the old trees' storage, bit
    for bit what ``donate=False`` returns as new trees."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import OptConfig, opt_init
    spec, params, tok = _reduced_qwen3()
    batch, cfg = {"tokens": tok, "labels": tok}, OptConfig(lr=1e-2, warmup=1)
    outs = []
    for donate in (False, True):
        p = T.tree_map(torch.clone, params)
        o = opt_init(p, cfg)
        before = [t.data_ptr() for t in T.leaves((p, o))]
        for _ in range(2):
            p2, o2, st = build_train_step(spec, cfg, donate=donate)(p, o,
                                                                     batch)
            same = [a is b for a, b in zip(T.leaves((p2, o2)),
                                           T.leaves((p, o)))]
            assert all(same) if donate else not any(same)
            p, o = p2, o2
        if donate:
            assert [t.data_ptr() for t in T.leaves((p, o))] == before
        outs.append((p, o, st["loss"]))
    for a, b in zip(T.leaves(outs[0]), T.leaves(outs[1])):
        assert torch.equal(a, b)


def test_serve_step_without_donate_leaves_the_state():
    """``donate=False`` steps on a copy of the decode state; the default
    writes the caches in place.  Both give the same tokens and state."""
    from repro_torch.launch.steps import build_serve_step
    spec, params, tok = _reduced_qwen3()
    got = []
    for donate in (True, False):
        state = tapi.decode_state(spec, 4, 24, device="cpu")
        nt, new = build_serve_step(spec, donate=donate)(params, state, tok,
                                                        0)
        assert (new["kv"][0] is state["kv"][0]) == donate
        assert bool(state["kv"][0].any()) == donate
        got.append((nt, new))
    assert torch.equal(got[0][0], got[1][0])
    for a, b in zip(T.leaves(got[0][1]), T.leaves(got[1][1])):
        assert torch.equal(a, b)
