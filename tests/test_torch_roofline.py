"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``): the framework-free analytic models
equal float for float on every cell of ``all_cells()`` on both production
meshes, and the meta run's FLOPs (``FlopCounterMode``) against the
reference's ``HloCostModel`` over the program XLA compiles for the same
smoke-sized cell on one device.

S = 64 keeps both packages on the naive attention path (the reference's
chunked form starts past 512 positions)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.training.optimizer import AdamWConfig as JAdamW  # noqa: E402
from repro.training.optimizer import adamw_init as jadamw_init  # noqa: E402
from repro.training.train_step import make_train_step as jmake_train_step  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402

MESH_SHAPES = [make_production_mesh(multi_pod=m).shape for m in (False, True)]
B, S = 2, 64
# the meta run's FLOPs against HloCostModel's, relative. The forwards count
# the same products exactly. The train steps' backwards differ by the
# products each autodiff leaves out: none for the dense arch; GShard's
# dispatch einsums (moe) and the chunked scan's (ssm) leave a gap measured
# at 1.3e-4 and 4.5e-3 of the total
FLOP_TOL = {("olmo-1b", "prefill"): 0.0, ("granite-moe-1b-a400m", "prefill"): 0.0,
            ("rwkv6-3b", "prefill"): 0.0, ("olmo-1b", "train"): 0.0,
            ("granite-moe-1b-a400m", "train"): 2e-4, ("rwkv6-3b", "train"): 5e-3}


def test_cells_match_reference():
    assert treg.all_cells() == jreg.all_cells()


@pytest.mark.parametrize("mesh", MESH_SHAPES, ids=["single", "multi"])
def test_analytic_models_match_reference_on_every_cell(mesh):
    """model_flops_per_device, analytic_memory_bytes and
    analytic_resident_bytes: the reference's values on each of the 32
    cells, float for float."""
    for arch, shape in treg.all_cells():
        assert troof.model_flops_per_device(arch, shape, mesh) == \
            jroof.model_flops_per_device(arch, shape, mesh), (arch, shape)
        assert troof.analytic_memory_bytes(arch, shape, mesh) == \
            jroof.analytic_memory_bytes(arch, shape, mesh), (arch, shape)
        assert troof.analytic_resident_bytes(arch, shape, mesh) == \
            jroof.analytic_resident_bytes(arch, shape, mesh), (arch, shape)


def test_cost_adds_as_the_reference():
    a, b = troof.Cost(), jroof.Cost()
    for c in (a, b):
        c.add(type(c)(flops=3.0, bytes=5.0, coll_bytes={"all-reduce": 7.0},
                      coll_count={"all-reduce": 2}), 2.5)
    assert (a.flops, a.bytes, a.coll_bytes, a.coll_count, a.total_coll_bytes) == (
        b.flops, b.bytes, b.coll_bytes, b.coll_count, b.total_coll_bytes)


def _reference_flops(arch, kind):
    cfg = dataclasses.replace(jreg.get_smoke(arch), dtype="float32", param_dtype="float32")
    p = jlm.init_params(cfg, jax.random.PRNGKey(0))
    toks = jnp.zeros((B, S), jnp.int32)
    if kind == "prefill":
        lowered = jax.jit(lambda p, b: jlm.prefill(cfg, p, b)).lower(p, {"tokens": toks})
    else:
        opt = JAdamW()
        lowered = jax.jit(jmake_train_step(cfg, opt)).lower(
            p, jadamw_init(p, opt), {"tokens": toks, "labels": toks})
    return jroof.HloCostModel(lowered.compile().as_text()).entry_cost().flops


def _meta_flops(arch, kind):
    cfg = dataclasses.replace(treg.get_smoke(arch), dtype="float32", param_dtype="float32")
    p = tlm.abstract_params(cfg)
    toks = torch.empty((B, S), dtype=torch.int32, device="meta")
    with FlopCounterMode(display=False) as fc:
        if kind == "prefill":
            tlm.prefill(cfg, p, toks)
        else:
            opt = AdamWConfig()
            make_train_step(cfg, opt)(p, adamw_init(p, opt), {"tokens": toks, "labels": toks})
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,kind", list(FLOP_TOL))
def test_meta_flops_match_hlo_cost_model(arch, kind):
    """Smoke-sized dense, moe (GShard dispatch) and ssm cells on one device:
    the meta run's FLOPs within FLOP_TOL of HloCostModel's."""
    want, got = _reference_flops(arch, kind), _meta_flops(arch, kind)
    assert want > 0 and got > 0
    assert abs(got - want) <= FLOP_TOL[(arch, kind)] * want, (got, want)


def test_collectives_priced_by_their_group():
    """A group within one 8-GPU node is priced at NVLink's rate, one that
    spans nodes at the network's; the log keeps the reference's kind
    names."""
    log = troof.CollectiveLog()
    log("psum", 1000, list(range(8)))
    log("all_gather", 500, [0, 16, 32])
    log("reduce_scatter", 200, [8, 9])
    assert log.cost.coll_bytes == {"all-reduce": 1000, "all-gather": 500,
                                   "reduce-scatter": 200}
    assert log.cost.coll_count == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 1}
    assert (log.intra_bytes, log.inter_bytes) == (1200, 500)
    assert log.seconds == pytest.approx(1200 / troof.NVLINK_BW + 500 / troof.NET_BW)
