"""The port's parallelism (``ivit_tpu_torch.parallel``) against the JAX
package's, on the CPU over gloo.

* Layouts: the port's ``param_shardings`` on the ViT and Swin sims' trees
  and its ``engine_param_shardings`` on a ViT spec equal JAX's ``.spec``
  leaf for leaf (JAX on the suite's 8 virtual CPU devices, nothing
  compiled); the head-aligned local shards joined back equal the full
  leaf, and model rank r's q, k and v columns are heads [r H/tp, (r+1)
  H/tp); ``tp`` must divide the heads (a deliberate divergence: GSPMD
  takes any width).
* One spawned world of 4 gloo ranks (``tests/_torch_parallel_workers.py``),
  ``file://`` rendezvous under ``tmp_path``, one torch thread a rank:
  the engine at dp x tp 4x1, 2x2 and 1x4 on a 4-head 64 px model,
  ``kernels=False`` and ``"ops"`` (the plain versions on the CPU), bitwise
  JAX's ``engine_forward(pallas=False)`` on the same spec and images;
  ``kernels=True`` refuses tp > 1 and tp 4 refuses 6 heads; the Swin
  engine (heads (2, 4)) at 2x2 plain and 4x1 fused bitwise the port's
  single-device engine and JAX's ``swin_engine_forward(pallas=False)``,
  with the same refusals; the ViT and Swin (heads (2, 4)) sims at dp 2 x
  tp 2 bitwise the single-device sim and JAX's engine on its freeze and
  the same images; calibration under dp 2 x tp 2 bitwise single-device
  calibration on the global batch (EMA, momentum -1, percentile, ibert,
  Swin; per-channel QuantActs); the exact int32 sum over the world wraps
  as a single-device int32 sum does.
* The server over ``devices=["cpu"] * 4`` and over ``make_mesh(2, 2,
  ["cpu"] * 4)``: logits bitwise ``Engine(spec, device="cpu")``'s and JAX's;
  ``batch_size % dp`` raises.

The port's sims are calibrated and frozen by the port; their trees and
specs equal JAX's leaf for leaf (``test_torch_port_freeze.py``), so they
are handed to JAX as they are.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import _torch_parallel_workers as W  # noqa: E402
from test_torch_port_engine import _to_jax  # noqa: E402

from ivit_tpu.engine import swin_int as jswin  # noqa: E402
from ivit_tpu.engine.vit_int import engine_forward as jax_engine_forward  # noqa: E402
from ivit_tpu.models import BitWidths as JaxBitWidths  # noqa: E402
from ivit_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from ivit_tpu.parallel import param_shardings as jax_param_shardings  # noqa: E402
from ivit_tpu.parallel.mesh import engine_param_shardings as jax_engine_shardings  # noqa: E402
from ivit_tpu_torch.engine import Engine  # noqa: E402
from ivit_tpu_torch.engine.freeze import freeze_model  # noqa: E402
from ivit_tpu_torch.engine.serving import ServingEngine  # noqa: E402
from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec  # noqa: E402
from ivit_tpu_torch.models.convert import differing_leaves, variables_to_numpy  # noqa: E402
from ivit_tpu_torch.parallel import launch  # noqa: E402
from ivit_tpu_torch.parallel import mesh as pm  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's CPU forwards (Tier-1 runs six
    workers at once; the integer paths' bits do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vit():
    """The 4-head 64 px ViT sim calibrated on two batches of 8, and its spec."""
    sim = W.calibrate(W.vit_sim(), W.calib_batches(64, 0))
    return sim, freeze_model(sim)


@pytest.fixture(scope="module")
def swin():
    return W.calibrate(W.swin_sim(), W.calib_batches(56, 5))


@pytest.fixture(scope="module")
def swin_spec(swin):
    from ivit_tpu_torch.engine.swin_int import freeze_swin_model
    return freeze_swin_model(swin)


@pytest.fixture(scope="module")
def world(vit, swin, swin_spec, tmp_path_factory):
    """The 4-rank world's results (rank order) and its inputs."""
    sim, spec = vit
    x, xs = W.images(W.BATCH, 64, 1), W.images(W.BATCH, 56, 3)
    spec6 = synthetic_spec(deit_small_config(depth=1, img_size=32, ln="ivit",
                                             gelu="ivit", softmax="ivit"), seed=0)
    rdv = tmp_path_factory.mktemp("rendezvous") / "file"
    res = launch.spawn(W.engine_and_sim_rank, 4, devices=["cpu"] * 4,
                       init_file=str(rdv),
                       args=(spec, x, spec6, (sim, x), (swin, xs), swin_spec),
                       timeout=300)
    return res, {"x": x, "xs": xs}


@pytest.fixture(scope="module")
def jax_logits(vit, world):
    """JAX's unfused engine on the spec and the world's images."""
    return np.asarray(jax.jit(lambda a: jax_engine_forward(_to_jax(vit[1]), a,
                                                            pallas=False))(
        jnp.asarray(world[1]["x"])))


@pytest.fixture(scope="module")
def jax_swin_logits(swin_spec, world):
    """JAX's unfused Swin engine on the Swin freeze and the world's images."""
    d = dataclasses.asdict(swin_spec.config)
    d["bitwidths"] = JaxBitWidths(*swin_spec.config.bitwidths.to_list())
    cfg = jswin.SwinEngineConfig(**d)
    params = jax.tree.map(jnp.asarray, swin_spec.params)
    return np.asarray(jax.jit(lambda p, a: jswin.swin_engine_forward(
        jswin.SwinEngineSpec(cfg, p), a, pallas=False))(params,
                                                        jnp.asarray(world[1]["xs"])))


def _rows(res, key, dp, tp):
    """The global batch from the ranks' local rows (one rank a data row),
    after checking that the model ranks of a row agree."""
    for r in range(dp * tp):
        np.testing.assert_array_equal(res[r][key], res[r - r % tp][key])
    return np.concatenate([res[d * tp][key] for d in range(dp)])


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

def _flat_specs(tree):
    """``{path: spec tuple}`` of a JAX NamedSharding tree or the port's."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda v: isinstance(v, tuple))[0]:
        key = tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = tuple(leaf.spec) if hasattr(leaf, "spec") else tuple(leaf)
    return out


@pytest.mark.parametrize("which", ["vit", "swin", "engine"])
def test_shardings_equal_jax(vit, swin, which):
    jmesh = jax_make_mesh(dp=4, tp=2)
    if which == "engine":
        params = vit[1].params
        want = jax_engine_shardings(params, jmesh)
        got = pm.engine_param_shardings(params, None)
    else:
        tree = variables_to_numpy(vit[0] if which == "vit" else swin)
        want = jax_param_shardings(tree, jmesh)
        got = pm.param_shardings(tree, None)
    want, got = _flat_specs(want), _flat_specs(got)
    assert got == want
    assert (None, "model") in got.values() and ("model", None) in got.values()


def _fake_mesh(r, tp):
    """Model rank ``r`` of a dp 1 x tp mesh, without a world (the cut only
    reads the coordinates)."""
    return pm.Mesh(np.arange(tp).reshape(1, tp), distributed=True, rank=r)


@pytest.mark.parametrize("tp", [2, 4])
def test_local_shards_are_head_aligned(vit, tp):
    sim, spec = vit
    tree = variables_to_numpy(sim)
    parts = [pm.shard_variables(tree, _fake_mesh(r, tp))[0] for r in range(tp)]
    eparts = [pm.shard_engine_params(spec.params, _fake_mesh(r, tp))[0]
              for r in range(tp)]
    qkv = tree["params"]["blocks_0"]["attn"]["qkv"]["kernel"]         # [64, 192]
    heads, dh = 4, 16
    for r in range(tp):
        cols = [s * 64 + h * dh + d for s in range(3)
                for h in range(r * heads // tp, (r + 1) * heads // tp) for d in range(dh)]
        np.testing.assert_array_equal(parts[r]["params"]["blocks_0"]["attn"]["qkv"]["kernel"],
                                      qkv[:, cols])
        np.testing.assert_array_equal(eparts[r]["blocks"][0]["m_qkv"],
                                      np.asarray(spec.params["blocks"][0]["m_qkv"])[cols])
    for name, cut in (("qkv", (-1, True)), ("fc1", (-1, False)), ("fc2", (0, False)),
                      ("proj", (0, False))):
        mod = "attn" if name in ("qkv", "proj") else "mlp"
        full = tree["params"]["blocks_1"][mod][name]["kernel"]
        joined = pm._join([torch.from_numpy(p["params"]["blocks_1"][mod][name]["kernel"])
                           for p in parts], cut)
        np.testing.assert_array_equal(joined.numpy(), full)
    for leaf, cut in (("qkv_w", (-1, True)), ("qkv_b", (0, True)), ("fc1_b", (0, False)),
                      ("proj_w", (0, False)), ("fc2_w", (0, False))):
        joined = pm._join([torch.from_numpy(np.asarray(p["blocks"][1][leaf]))
                           for p in eparts], cut)
        np.testing.assert_array_equal(joined.numpy(), np.asarray(spec.params["blocks"][1][leaf]))
    # replicated leaves stay whole
    np.testing.assert_array_equal(parts[-1]["params"]["blocks_0"]["norm1"]["weight"],
                                  tree["params"]["blocks_0"]["norm1"]["weight"])


def test_tp_must_divide_heads_and_hidden(swin):
    """Deliberate divergence (ROADMAP Queue 3): GSPMD shards any width
    (``tests/test_parallel.py:102`` runs tp 4 on 2 heads); the port's
    head-aligned shards need tp to divide every heads and hidden width."""
    with pytest.raises(ValueError, match="does not divide the heads of "
                                         "layers_0_blocks_0.attn 2"):
        pm.check_model_tp(swin, 4)
    with pytest.raises(ValueError, match="num_heads 6"):
        pm.check_engine_tp(deit_small_config(), 4)
    pm.check_model_tp(swin, 2)
    pm.check_engine_tp(deit_small_config(), 3)
    with pytest.raises(ValueError, match=r"dp\*tp = 3\*2 != 4 devices"):
        pm.make_mesh(3, 2, ["cpu"] * 4)
    assert pm.make_mesh(None, 2, ["cpu"] * 4).shape == {"data": 2, "model": 2}


# ---------------------------------------------------------------------------
# The engine and the sim on a 4-rank world
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,tp", W.ENGINE_MESHES)
@pytest.mark.parametrize("kernels", [False, "ops"])
def test_sharded_engine_matches_jax(world, jax_logits, dp, tp, kernels):
    for r in range(4):                     # every rank holds the gathered logits
        np.testing.assert_array_equal(world[0][r]["engine"][(dp, tp, kernels)],
                                      jax_logits)


def test_sharded_engine_refusals(world):
    refusals = world[0][0]["refusals"]
    assert "no partial sum to reduce under tp=2" in refusals["kernels_true_tp2"]
    assert "tp=4 does not divide num_heads 6" in refusals["tp4_six_heads"]
    assert "no partial sum to reduce under tp=2" in refusals["swin_kernels_true_tp2"]
    assert "tp=4 does not divide the heads of stage 0 2" in refusals["swin_tp4"]


@pytest.mark.parametrize("case", W.SWIN_ENGINE_CASES)
def test_sharded_swin_engine_matches_single_device(world, swin_spec,
                                                   jax_swin_logits, case):
    """The Swin engine on a mesh (JAX's is not sharded in its tests) against
    the port's single-device plain engine and JAX's ``swin_engine_forward``
    on the same spec and images."""
    from ivit_tpu_torch.engine.swin_int import swin_engine_forward
    want = swin_engine_forward(swin_spec, world[1]["xs"], kernels=False,
                               device="cpu").numpy()
    np.testing.assert_array_equal(want, jax_swin_logits)
    for r in range(4):
        np.testing.assert_array_equal(world[0][r]["swin_engine"][case], jax_swin_logits)


def test_sharded_vit_sim_forward_matches_single_device_and_jax(world, vit,
                                                               jax_logits):
    """dp 2 x tp 2: the ViT sim's logits bitwise the single-device sim's,
    which are its freeze's engine logits, JAX's ``engine_forward`` on the
    same spec and images (``jax_logits``): the sim is exact where the
    engine is (``test_torch_port_freeze.py``).  JAX's jitted sim forward
    costs 20-30 s a model under Tier-1's load; its equality with the
    port's single-device sim is ``test_torch_port_qat.py``'s."""
    got = _rows(world[0], "vit_fwd", *W.SIM_MESH)
    with torch.no_grad():
        want = vit[0](torch.from_numpy(world[1]["x"])).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_logits)


def test_sharded_swin_sim_forward_matches_single_device_and_engine(world, swin,
                                                                   jax_swin_logits):
    """dp 2 x tp 2, heads (2, 4): the Swin sim's logits bitwise the
    single-device sim's, which are its freeze's engine logits, JAX's
    ``swin_engine_forward`` on the same spec and images
    (``jax_swin_logits``), as for the ViT above; the single-device sim's
    equality with JAX's sim is ``test_torch_port_swin_qat.py``'s."""
    x = world[1]["xs"]
    got = _rows(world[0], "swin_fwd", *W.SIM_MESH)
    with torch.no_grad():
        want = swin(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_swin_logits)


@pytest.mark.parametrize("case", [*(f"vit_{m}" for m in W.CALIB_MODES),
                                  "vit_ibert", "swin"])
def test_sharded_calibration_matches_single_device(world, case):
    """dp 2 x tp 2: every range over the global batch (and over the model
    axis where the input is cut there) bitwise single-device calibration.
    JAX's calibration is not run on these batches: eagerly it costs about a
    minute a model here, and jitted it moves a residual range by an ulp
    (ROADMAP Queue 3); ``test_torch_port_qat.py`` and ``_swin_qat.py`` hold
    the single-device calibration to JAX's eager one."""
    res = world[0]
    if case == "swin":
        ref = W.calibrate(W.swin_sim(), W.calib_batches(56, 20))
    elif case == "vit_ibert":
        ref = W.calibrate(W.vit_sim("ibert", "ibert"), W.calib_batches(64, 10))
    else:
        mode = case.split("_", 1)[1]
        ref = W.calibrate(W.set_calib_mode(W.vit_sim(), mode), W.calib_batches(64, 10))
    want = W.quant_stats(ref)
    for r in range(4):
        assert differing_leaves(res[r][f"qs_{case}"], want) == []


def test_all_reduce_exact_wraps_as_int32(world):
    """The int32 sum over the mesh wraps as the single-device int32 sum of
    the same values does."""
    want = np.sum(np.stack([W.exact_sum_operand(r).numpy() for r in range(4)]),
                  axis=0, dtype=np.int32)
    assert want[0] < 0 and want[1] > 0          # both ways past 2**31
    for r in range(4):
        np.testing.assert_array_equal(world[0][r]["sum_i32"], want)


def test_sharded_per_channel_ranges(world):
    want = W.run_acts(W.per_channel_acts(), W.per_channel_inputs())
    for r in range(4):
        got = world[0][r]["acts"]
        for name in want:
            np.testing.assert_array_equal(got[name][0], want[name][0])
            np.testing.assert_array_equal(got[name][1], want[name][1])


# ---------------------------------------------------------------------------
# The server over a mesh of devices (one process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["devices", "mesh"])
def test_mesh_server_matches_engine_and_jax(vit, world, jax_logits, how):
    spec = vit[1]
    images = world[1]["x"]
    want = Engine(spec, device="cpu")(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(want, jax_logits)
    kw = ({"devices": ["cpu"] * 4} if how == "devices"
          else {"mesh": pm.make_mesh(2, 2, ["cpu"] * 4)})
    with ServingEngine(spec, batch_size=4, max_wait_ms=20, **kw) as srv:
        assert len(srv.engines) == (4 if how == "devices" else 2)
        got = srv.infer(images)
        assert srv.metrics.summary()["batches"] == 2
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="not divisible by the mesh's data axis"):
        ServingEngine(spec, batch_size=5, **kw)
