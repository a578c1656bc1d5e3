"""The port's energy, customization and MicroBlaze models, its area proxy
(``MachineConfig.lut_bits``/``state_bits``) and the ``flexgrip`` config
against the JAX package, with ``==``: the same counters priced by both
packages' ``activity_energy``/``simt_energy``/``scalar_energy`` (total and
every component), ``scalar_model_cycles``/``scalar_cycles``, the static
binary analysis and the variant catalog, and ``RefMachine`` on seeded
random programs."""
import dataclasses
import functools

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.core import customize as jcustomize
from repro.core import energy as jenergy
from repro.core import microblaze as jmicroblaze
from repro.core import scheduler as jscheduler
from repro.core.machine import MachineConfig as JaxConfig
from repro_torch import configs
from repro_torch.core import customize, energy, microblaze, scheduler
from repro_torch.core.machine import MachineConfig
from repro_torch.core.pipeline.state import config_from_reference
from repro_torch.core.programs import ALL
from test_customize_energy import _divergent_program, _straightline_program
from test_torch_parity import random_branchy, random_straightline

#: configurations priced by both packages: SP counts, the Table 6 axes
CONFIGS = {"baseline": {}, "sp16": dict(n_sp=16), "sp32": dict(n_sp=32),
           "stack2_nomul": dict(warp_stack_depth=2, enable_mul=False,
                                num_read_operands=2),
           "stack16": dict(warp_stack_depth=16)}


def _configs(kw):
    """(JAX config, port config) with the same architecture."""
    j = JaxConfig(**kw)
    return j, config_from_reference(dataclasses.asdict(j))


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in ("execute_backend", "pallas_interpret")}


@functools.lru_cache(maxsize=None)
def _result(name):
    """The JAX package's GridResult of ``name`` at n=32, and the same
    numbers as the port's GridResult."""
    mod = ALL[name]
    g0 = mod.make_gmem(np.random.default_rng(0), 32)
    jres = jscheduler.run_grid(mod.build(32), *mod.launch(32), g0,
                               JaxConfig())
    return jres, scheduler.GridResult(*(np.asarray(x) for x in jres))


def _same_report(got, want):
    assert got.total == want.total
    assert got.by_component == want.by_component
    assert str(got) == str(want)


@pytest.mark.parametrize("cname", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(ALL))
def test_energy_matches_jax(name, cname):
    jres, res = _result(name)
    jcfg, cfg = _configs(CONFIGS[cname])
    for n_sm in (1, 2):
        _same_report(energy.simt_energy(res, cfg, n_sm),
                     jenergy.simt_energy(jres, jcfg, n_sm))
    _same_report(
        energy.activity_energy(res.op_issues, res.op_lanes, res.stack_ops,
                               res.sm_cycles(2), cfg, 2),
        jenergy.activity_energy(jres.op_issues, jres.op_lanes,
                                jres.stack_ops, jres.sm_cycles(2), jcfg, 2))
    n_threads = ALL[name].n_threads(32)
    _same_report(energy.scalar_energy(res, n_threads),
                 jenergy.scalar_energy(jres, n_threads))
    assert energy.scalar_model_cycles(res, n_threads) == \
        jenergy.scalar_model_cycles(jres, n_threads)
    assert microblaze.scalar_cycles(res.op_lanes, n_threads) == \
        jmicroblaze.scalar_cycles(jres.op_lanes, n_threads)


def test_model_tables_match_jax():
    assert energy.E_EVENT == jenergy.E_EVENT
    assert energy.E_IDLE == jenergy.E_IDLE
    assert microblaze.SCALAR_CPI == jmicroblaze.SCALAR_CPI
    assert microblaze.SCALAR_THREAD_OVERHEAD == \
        jmicroblaze.SCALAR_THREAD_OVERHEAD
    for op in range(-1, 30):
        assert microblaze.classify(op) == jmicroblaze.classify(op)


def _binaries():
    """(tag, code): the paper programs at n=32 and the hand-made binaries
    of tests/test_customize_energy.py."""
    out = [(name, ALL[name].build(32)) for name in sorted(ALL)]
    out += [(f"divergent{k}", _divergent_program(k)) for k in (1, 2)]
    out += [("straight", _straightline_program()),
            ("straight_mul", _straightline_program(with_mul=True)),
            ("straight_imad", _straightline_program(with_imad=True))]
    return out


@pytest.mark.parametrize("tag,code", _binaries(),
                         ids=[t for t, _ in _binaries()])
def test_customization_matches_jax(tag, code):
    assert dataclasses.asdict(customize.analyze(code)) == \
        dataclasses.asdict(jcustomize.analyze(code))
    assert customize.analyze(code).required_stack_depth == \
        jcustomize.analyze(code).required_stack_depth
    for kw in ({}, dict(n_sp=32, warp_stack_depth=8)):
        jbase, base = _configs(kw)
        got = customize.minimal_config(code, base)
        assert _fields(got) == _fields(jcustomize.minimal_config(code, jbase))
        assert got.execute_backend == base.execute_backend
    assert customize.select_variant(code) == jcustomize.select_variant(code)
    for vname, vcfg in jcustomize.VARIANT_CATALOG.items():
        assert customize.validate(code, customize.VARIANT_CATALOG[vname]) \
            == jcustomize.validate(code, vcfg)


def test_variant_catalog_matches_jax():
    assert list(customize.VARIANT_CATALOG) == \
        list(jcustomize.VARIANT_CATALOG)
    for name, cfg in customize.VARIANT_CATALOG.items():
        assert isinstance(cfg, MachineConfig)
        assert cfg.execute_backend == "cuda_fused"
        assert _fields(cfg) == _fields(jcustomize.VARIANT_CATALOG[name])


@pytest.mark.parametrize("n_sp", [8, 16, 32])
def test_area_proxy_matches_jax(n_sp):
    for kw in CONFIGS.values():
        jcfg, cfg = _configs({**kw, "n_sp": n_sp})
        for n_warps in (8, 4, 32):
            assert cfg.lut_bits(n_warps) == jcfg.lut_bits(n_warps)
            assert cfg.state_bits(n_warps) == jcfg.state_bits(n_warps)
        assert cfg.lut_bits() == jcfg.lut_bits()
        assert cfg.state_bits() == jcfg.state_bits()


def _ref_programs():
    out = []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        out.append((random_straightline(rng), 40,
                    rng.integers(-1000, 1000, 40 * 8, dtype=np.int32)))
    for seed in range(4):
        rng = np.random.default_rng(seed + 100)
        out.append((random_branchy(rng), 64, np.zeros(64, np.int32)))
    return out


@pytest.mark.parametrize("k", range(8))
def test_refmachine_matches_jax(k):
    code, bd, gmem = _ref_programs()[k]
    for kw in ({}, dict(n_sp=32, enable_mul=False)):
        jcfg, cfg = _configs(kw)
        got = microblaze.RefMachine(code, bd, (0, 0), (1, 1), gmem, cfg)
        want = jmicroblaze.RefMachine(code, bd, (0, 0), (1, 1), gmem, jcfg)
        g_mem, g_gw, g_cyc = got.run()
        w_mem, w_gw, w_cyc = want.run()
        np.testing.assert_array_equal(g_mem, w_mem)
        np.testing.assert_array_equal(g_gw, w_gw)
        assert (g_cyc, got.max_sp, got.issues) == \
            (w_cyc, want.max_sp, want.issues)


def test_flexgrip_config_matches_jax():
    spec, jspec = configs.get("flexgrip"), jconfigs.get("flexgrip")
    assert (spec.name, spec.family, spec.skips, spec.source) == \
        (jspec.name, jspec.family, jspec.skips, jspec.source)
    want = config_from_reference(dataclasses.asdict(jspec.cfg))
    assert spec.cfg == dataclasses.replace(want,
                                           execute_backend="cuda_fused")
    assert spec.cfg == MachineConfig()
    assert "flexgrip" in configs.PORTED and configs.get("flexgrip") is spec
