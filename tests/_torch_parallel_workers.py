"""Rank functions of the port's sharded tests.

``ivit_tpu_torch.parallel.launch.spawn`` starts fresh interpreters that
import a rank function by its module's name: this module imports torch,
numpy and the port only (no JAX), so that a rank starts in a second.  Its
model and data constructors are shared with the tests, which compute the
single-device and JAX references in the parent process.
"""

import copy

import numpy as np
import torch

ENGINE_MESHES = ((4, 1), (2, 2), (1, 4))
CALIB_MODES = ("ema", "momentum", "percentile")
SIM_MESH = (2, 2)
TRAIN_MESHES = ((4, 1), (2, 2))
BATCH = 8
NUM_CLASSES = 10


def images(n, img, seed):
    return np.random.default_rng(seed).normal(size=(n, img, img, 3)).astype(np.float32)


def vit_sim(fam="ivit", ln="ivit", heads=4, depth=2, seed=0, device="cpu", **kw):
    """The tests' 64 px ViT: depth 2, embed 64, ``heads`` heads (hidden
    256), 10 classes."""
    from ivit_tpu_torch.models import VisionTransformer
    return VisionTransformer(img_size=64, patch_size=16, embed_dim=64, depth=depth,
                             num_heads=heads, num_classes=NUM_CLASSES, gelu_type=fam,
                             softmax_type=fam, layernorm_type=ln, device=device,
                             seed=seed, **kw)


def swin_sim(seed=0):
    """``tests/test_parallel.py:76``'s Swin: 56 px, depths (2, 2), heads
    (2, 4), embed 32."""
    from ivit_tpu_torch.models import SwinTransformer
    return SwinTransformer(img_size=56, patch_size=4, embed_dim=32, depths=(2, 2),
                           num_heads=(2, 4), window_size=7, num_classes=NUM_CLASSES,
                           drop_path_rate=0.0, device="cpu", seed=seed)


def set_calib_mode(model, mode):
    """Every QuantAct of ``model`` in a range mode of ``tests/test_model.py``:
    the EMA (as built), running min/max (momentum -1) or percentile."""
    from ivit_tpu_torch.models.layers import QuantAct
    for m in model.modules():
        if isinstance(m, QuantAct):
            if mode == "momentum":
                m.act_range_momentum = -1
            elif mode == "percentile":
                m.percentile = 99.0
    return model


def calibrate(model, batches):
    with torch.no_grad():
        for b in batches:
            model(torch.as_tensor(b), running_stat=True)
    return model


def calib_batches(img, seed):
    return [images(BATCH, img, seed + i) for i in range(2)]


def quant_stats(model):
    from ivit_tpu_torch.models.convert import variables_to_numpy
    return variables_to_numpy(model)["quant_stats"]


def per_channel_inputs():
    """Inputs of the standalone per-channel QuantActs: [8, 5, 16]."""
    return [np.random.default_rng(40 + i).normal(size=(BATCH, 5, 16)).astype(np.float32)
            for i in range(2)]


def per_channel_acts():
    from ivit_tpu_torch.models.layers import QuantAct
    return {"per_channel": QuantAct(per_channel=True, channel_len=16),
            "per_channel_percentile": QuantAct(per_channel=True, channel_len=16,
                                               percentile=98.0)}


def run_acts(acts, batches, rows=lambda b: b):
    out = {}
    for name, act in acts.items():
        with torch.no_grad():
            for b in batches:
                act(torch.from_numpy(rows(b)), running_stat=True)
        out[name] = (act.x_min.numpy().copy(), act.x_max.numpy().copy())
    return out


# ---------------------------------------------------------------------------
# The engine and sim world (tests/test_torch_port_parallel.py)
# ---------------------------------------------------------------------------

SWIN_ENGINE_CASES = ((2, 2, False), (4, 1, True))


def engine_and_sim_rank(rank, spec, x, spec6, vit_fwd, swin_fwd, swin_spec):
    """On a 4-rank world: the sharded engine at every ``ENGINE_MESHES`` on
    both plain paths, its refusals; the sharded Swin engine at
    ``SWIN_ENGINE_CASES``; the sharded sim forwards and calibrations on
    ``SIM_MESH``.  ``vit_fwd`` / ``swin_fwd``: (calibrated single-device
    sim, its images); ``swin_spec``: the Swin sim's freeze."""
    from ivit_tpu_torch.engine.swin_int import swin_engine_forward
    from ivit_tpu_torch.engine.vit_int import engine_forward
    from ivit_tpu_torch.parallel import (collectives as coll, local_rows, make_mesh,
                                         shard_engine_params, shard_module)

    out = {"engine": {}, "refusals": {}}
    for dp, tp in ENGINE_MESHES:
        mesh = make_mesh(dp, tp)
        local, _ = shard_engine_params(spec.params, mesh)
        lspec = type(spec)(spec.config, local)
        for k in (False, "ops"):
            y = engine_forward(lspec, local_rows(x, mesh), kernels=k, mesh=mesh)
            out["engine"][(dp, tp, k)] = y.numpy()
    mesh = make_mesh(2, 2)
    local, _ = shard_engine_params(spec.params, mesh)
    for name, call in (
            ("kernels_true_tp2", lambda: engine_forward(
                type(spec)(spec.config, local), local_rows(x, mesh), kernels=True,
                mesh=mesh)),
            ("tp4_six_heads", lambda: engine_forward(
                spec6, x, kernels=False, mesh=make_mesh(1, 4))),
            ("swin_kernels_true_tp2", lambda: swin_engine_forward(
                swin_spec, local_rows(swin_fwd[1], mesh), kernels=True, mesh=mesh)),
            ("swin_tp4", lambda: swin_engine_forward(
                swin_spec, swin_fwd[1], kernels=False, mesh=make_mesh(1, 4)))):
        try:
            call()
            out["refusals"][name] = None
        except ValueError as e:
            out["refusals"][name] = str(e)

    out["swin_engine"] = {}
    for dp, tp, k in SWIN_ENGINE_CASES:
        mesh = make_mesh(dp, tp)
        local, _ = shard_engine_params(swin_spec.params, mesh)
        out["swin_engine"][(dp, tp, k)] = swin_engine_forward(
            type(swin_spec)(swin_spec.config, local), local_rows(swin_fwd[1], mesh),
            kernels=k, mesh=mesh).numpy()

    mesh = make_mesh(*SIM_MESH)
    for name, (sim, xs) in (("vit", vit_fwd), ("swin", swin_fwd)):
        sharded = shard_module(copy.deepcopy(sim), mesh)
        with torch.no_grad():
            out[f"{name}_fwd"] = sharded(torch.from_numpy(local_rows(xs, mesh))).numpy()
    rows = lambda b: local_rows(b, mesh)  # noqa: E731
    for mode in CALIB_MODES:
        m = shard_module(set_calib_mode(vit_sim(), mode), mesh)
        out[f"qs_vit_{mode}"] = quant_stats(calibrate(m, map(rows, calib_batches(64, 10))))
    m = shard_module(vit_sim("ibert", "ibert"), mesh)
    out["qs_vit_ibert"] = quant_stats(calibrate(m, map(rows, calib_batches(64, 10))))
    m = shard_module(swin_sim(), mesh)
    out["qs_swin"] = quant_stats(calibrate(m, map(rows, calib_batches(56, 20))))
    with coll.use(mesh):
        out["acts"] = run_acts(per_channel_acts(), per_channel_inputs(), rows)
        out["sum_i32"] = coll.all_reduce_exact(exact_sum_operand(rank), "both").numpy()
    return out


def exact_sum_operand(rank):
    """Rank ``rank``'s int32 operand of the exact sum: values whose sum over
    4 ranks passes 2**31 both ways, and past 2**24."""
    return torch.tensor([2**29 + 2**27 + rank, -(2**29) - 2**27 - rank, 2**24 + rank,
                         -7 * rank],
                        dtype=torch.int32)


# ---------------------------------------------------------------------------
# The training world (tests/test_torch_port_parallel_train.py)
# ---------------------------------------------------------------------------

def train_tx():
    """``tests/test_parallel.py``'s optimizer (``optax.sgd(1e-3)``), after
    a clip by the global norm so that the sharded norm is exercised."""
    from ivit_tpu_torch.train import optim
    return optim.chain(optim.clip_by_global_norm(0.5),
                       optim.scale_by_learning_rate(lambda c: np.float32(1e-3)))


def train_sim():
    """The train step's sim: drop-path 0.1 (the masks drawn at the global
    shape), calibrated on one batch."""
    m = vit_sim(drop_path_rate=0.1)
    return calibrate(m, [images(BATCH, 64, 50)])


def train_batch():
    return {"image": images(BATCH, 64, 51),
            "label": np.random.default_rng(52).integers(0, NUM_CLASSES, BATCH)}


def train_step(model, batch):
    """One step (log_grad_norm on) from ``init_train_state``; returns
    (metrics as floats, params and quant_stats as numpy, gathered to the
    flax layout on a mesh)."""
    from ivit_tpu_torch.models.convert import variables_to_numpy, variables_tree
    from ivit_tpu_torch.parallel import gather_variables
    from ivit_tpu_torch.train import optim
    from ivit_tpu_torch.train.steps import init_train_state, make_train_step

    tx = train_tx()
    step = make_train_step(model, tx, NUM_CLASSES, log_grad_norm=True)
    _, metrics = step(init_train_state(model, tx), batch,
                      torch.Generator().manual_seed(3))
    params = variables_tree(model)["params"]
    if getattr(model, "mesh", None) is not None:
        params = gather_variables(params, model.mesh)
    return ({k: float(v) for k, v in metrics.items()},
            optim.tree_map(lambda t: t.detach().numpy().copy(), params),
            variables_to_numpy(model)["quant_stats"])


def small_str2model(name):
    """The registry's names, all built as the tests' 64 px 4-head ViT."""
    def build(**kw):
        for k in ("img_size", "bitwidths", "num_classes"):
            kw.pop(k, None)
        fam = {k: kw.pop(k) for k in ("gelu_type", "softmax_type", "layernorm_type")}
        return vit_sim(fam["gelu_type"], fam["layernorm_type"], **kw)
    return build


def trainer_cfg(out_dir, epochs=1, **kw):
    from ivit_tpu_torch.train.trainer import TrainConfig
    return TrainConfig(model="deit_tiny_patch16_224", epochs=epochs, batch_size=8,
                       lr=1e-3, img_size=64, num_classes=NUM_CLASSES,
                       calibration_batches=1, mixup=0.0, cutmix=0.0, smoothing=0.0,
                       aa=None, output_dir=out_dir, run_id="mesh", log_interval=1,
                       model_ema=True, clip_grad=1.0, **kw)


def trainer_data():
    from ivit_tpu_torch.train.data import SyntheticDataset
    return (SyntheticDataset(n=16, num_classes=NUM_CLASSES, img_size=64),
            SyntheticDataset(n=8, num_classes=NUM_CLASSES, img_size=64, seed=1))


def train_rank(rank, out_dir):
    """On a 4-rank world: one train step at each ``TRAIN_MESHES``; a
    ``Trainer`` at ``mesh_dp=2, mesh_tp=2`` fitting one epoch, then a
    second resumed from its checkpoint."""
    from ivit_tpu_torch.parallel import make_mesh, shard_module
    from ivit_tpu_torch.train import trainer as trainer_mod

    out = {}
    for dp, tp in TRAIN_MESHES:
        model = shard_module(train_sim(), make_mesh(dp, tp))
        out[(dp, tp)] = train_step(model, train_batch())

    trainer_mod.str2model = small_str2model
    tr = trainer_mod.Trainer(trainer_cfg(out_dir, mesh_dp=2, mesh_tp=2), *trainer_data())
    best = tr.fit()
    out["fit"] = {"best_acc1": best, "step": int(tr.state["step"]),
                  "qkv_local": tuple(tr.model.blocks[0].attn.qkv.kernel.shape)}
    ckpt = f"{out_dir}/checkpoint_mesh"
    tr2 = trainer_mod.Trainer(trainer_cfg(out_dir, epochs=2, mesh_dp=2, mesh_tp=2,
                                          resume=ckpt), *trainer_data())
    out["resume"] = {"start_epoch": tr2.start_epoch, "step_before": int(tr2.state["step"])}
    tr2.fit()
    out["resume"]["step_after"] = int(tr2.state["step"])
    return out


# ---------------------------------------------------------------------------
# The card (tests/test_torch_port_cuda.py)
# ---------------------------------------------------------------------------

def cuda_engine_tp_rank(rank):
    """One of two gloo ranks on cuda:0: the ivit engine (DeiT-S widths,
    depth 2, 64 px) at tp 2 on the standalone kernels against the
    single-device ``Engine(spec, kernels="ops")``; and the collectives the
    sharded paths use, on CUDA tensors, against their expected values."""
    import torch.distributed as dist

    from ivit_tpu_torch.engine import Engine
    from ivit_tpu_torch.engine.convert import params_to_torch
    from ivit_tpu_torch.engine.synthetic import deit_small_config, synthetic_spec
    from ivit_tpu_torch.engine.vit_int import engine_forward
    from ivit_tpu_torch.ops.kernels import nonlinear as knl
    from ivit_tpu_torch.parallel import make_mesh, shard_engine_params
    from ivit_tpu_torch.parallel.launch import rank_device

    dev = rank_device()
    spec = synthetic_spec(deit_small_config(depth=2, img_size=64, ln="ivit", gelu="ivit",
                                            softmax="ivit"), seed=0)
    x = torch.from_numpy(images(4, 64, 7)).to(dev)
    want = Engine(spec, kernels="ops")(x)
    mesh = make_mesh(1, 2)
    local, _ = shard_engine_params(spec.params, mesh)
    lspec = type(spec)(spec.config, params_to_torch(local, dev))
    knl.shiftmax.launches = knl.shift_gelu_requant.launches = 0
    got = engine_forward(lspec, x, kernels="ops", mesh=mesh)
    torch.cuda.synchronize()
    out = {"equal": bool(torch.equal(got, want)),
           "launches": (knl.shiftmax.launches, knl.shift_gelu_requant.launches)}
    checks = {}
    for name, dtype, op, expect in (
            ("sum_i32", torch.int32, dist.ReduceOp.SUM, [1, 3, 5]),
            ("min_f32", torch.float32, dist.ReduceOp.MIN, [0.0, 1.0, 2.0]),
            ("max_f32", torch.float32, dist.ReduceOp.MAX, [1.0, 2.0, 3.0])):
        t = torch.arange(3, device=dev, dtype=dtype) + rank
        dist.all_reduce(t, op=op)
        checks[name] = t.is_cuda and t.tolist() == expect
    parts = [torch.empty(3, device=dev) for _ in range(2)]
    dist.all_gather(parts, torch.arange(3, device=dev, dtype=torch.float32) + rank)
    checks["all_gather_f32"] = torch.cat(parts).tolist() == [0, 1, 2, 1, 2, 3]
    out["gloo_cuda"] = checks
    return out


SERVED = 32          # requests the server answers beside the tp-2 forwards
TP_FORWARDS = 4


def serve_beside_tp_rank(rank, spec, x, served):
    """Both ranks run ``TP_FORWARDS`` tp-2 plain forwards of ``x``; on rank 0
    a ``ServingEngine`` thread on the CPU answers ``served``, one request at
    a time, all the while (its batcher enters ``use(None)`` for every
    batch).  Returns the tp logits, the answers, and how many answers had
    come back when the forwards started and when they ended."""
    import threading

    from ivit_tpu_torch.engine.serving import ServingEngine
    from ivit_tpu_torch.engine.vit_int import engine_forward
    from ivit_tpu_torch.parallel import make_mesh, shard_engine_params

    mesh = make_mesh(1, 2)
    local, _ = shard_engine_params(spec.params, mesh)
    lspec = type(spec)(spec.config, local)
    answers, first = [], threading.Event()
    srv = client = None
    if rank == 0:
        srv = ServingEngine(spec, batch_size=4, max_wait_ms=1, device="cpu",
                            kernels=False)

        def ask():
            for im in served:
                answers.append(srv.submit(im).result(timeout=120))
                first.set()
        client = threading.Thread(target=ask)
        client.start()
        first.wait(120)
    try:
        before = len(answers)
        logits = [engine_forward(lspec, x, kernels=False, mesh=mesh).numpy()
                  for _ in range(TP_FORWARDS)]
        after = len(answers)
    finally:
        if client is not None:
            client.join(120)
            srv.close()
    return {"tp": logits, "served": np.stack(answers) if answers else None,
            "answered": (before, after)}
