"""The roofline and model-step counts, and the reduction of a trace."""

import json
import os

import numpy as np
import pytest

from gpubench import cells, roofline, specmaker
from gpubench import trace as tr
from gpubench.harness import Run
from gpubench.kernels import attn_block, mlp_block, swin_attn_block
from gpubench.reference import swin, vit


def _spec(name, seed=0):
    cfg = json.load(open(os.path.join(cells.ROOT, f"gpubench/configs/{name}.json")))
    return specmaker.make(cfg, seed)


def _nbytes(*arrays):
    return sum(np.asarray(a).nbytes for a in arrays)


def test_deit_s_counts_equal_the_smokes_figures():
    cfg, p = _spec("deit_s_ibert")
    blk = p["blocks"][0]
    calls = vit.blocks(cfg, 256)
    x = np.zeros((256, 197, 384), np.int8)
    (mlp_ops, mlp_bytes), (attn_ops, attn_bytes) = (mlp_block.calls(calls)[0],
                                                    attn_block.calls(calls)[0])
    # chip_smoke.py's mlp_block and attn_block phases, at batch 256
    assert mlp_ops == 2 * 256 * 197 * 384 * 1536 * 2 and round(mlp_ops / 1e9, 1) == 119.0
    assert mlp_bytes == _nbytes(x, x, blk["fc1_w"], blk["fc2_w"], blk["fc1_b"],
                                blk["fc2_b"], blk["m_fc1"], blk["m_fc2"], blk["m_ln2"],
                                blk["ln2_bias_int"])
    assert round(attn_ops / 1e9, 1) == 74.8
    assert attn_bytes == _nbytes(x, x, blk["qkv_w"], blk["proj_w"], blk["qkv_b"],
                                 blk["proj_b"], blk["m_qkv"], blk["m_proj"], blk["m_ln1"],
                                 blk["ln1_bias_int"])
    assert round(roofline.bound_s(mlp_ops, mlp_bytes) * 1e6, 1) == 60.1
    assert round(roofline.bound_s(attn_ops, attn_bytes) * 1e6, 1) == 37.8
    assert len(mlp_block.calls(calls)) == len(attn_block.calls(calls)) == 12
    assert swin_attn_block.calls(calls) == []
    assert round(2 * vit.macs_per_image(cfg) / 1e9, 1) == 9.2


def test_swin_t_counts_follow_the_smokes_stage_shapes():
    cfg, p = _spec("swin_t_ivit")
    calls = swin.blocks(cfg, 64)
    assert len(calls) == 12 and attn_block.calls(calls) == []
    blks = [b for b, e in zip(p["blocks"], cfg["layout"]) if e[0] == "block"]
    stage_first = [0, 2, 4, 10]
    for st, i in enumerate(stage_first):
        b, c = blks[i + 1], 96 * 2**st
        rows = 64 * 3136 // 4**st
        x16 = np.zeros((rows, c), np.int16)
        ops, nbytes = swin_attn_block.calls(calls)[i + 1]
        assert ops == 2 * rows * 4 * c * c + 2 * 2 * rows * 49 * c
        mask = [b["mask_int"]] if "mask_int" in b else []
        assert nbytes == _nbytes(x16, x16, b["qkv_w"], b["proj_w"], b["qkv_b"], b["proj_b"],
                                 b["m_qkv"], b["m_proj"], b["m_ln1"], b["ln1_bias_int"],
                                 b["rel_bias_addend"], *mask)
        assert mlp_block.calls(calls)[i][0] == 2 * rows * c * 4 * c * 2
    # stage 0 binds on bytes, the later stages on operations (chip_smoke.py)
    bounds = swin_attn_block.calls(calls)
    assert bounds[0][1] / roofline.HBM_BYTES > bounds[0][0] / roofline.INT8_OPS
    assert bounds[-1][1] / roofline.HBM_BYTES < bounds[-1][0] / roofline.INT8_OPS
    assert 8.9 < 2 * swin.macs_per_image(cfg) / 1e9 < 9.1


def _trace(kernels, copies=(), host=(), window=(0.0, 10.0), batches=1):
    op = lambda t: tr.Op(*t)                                     # noqa: E731
    return tr.Trace([op(k) for k in kernels], [op(c) for c in copies],
                    [op(h) for h in host], window, batches)


def test_busy_time_is_the_union_of_device_intervals():
    t = _trace([("void a<1>(int)", 1, 3), ("b", 2, 4), ("c", 6, 7)],
               copies=[("Memcpy DtoH (Device -> Pageable)", 6.5, 8)],
               host=[("gpubench.batch", 0, 10), ("gpubench.to_host", 5, 9)])
    assert t.busy_s() == pytest.approx(5.0)
    assert t.idle_gaps() == [(0.0, 1), (4, 6), (8, 10.0)]
    b = tr.breakdown(t)
    assert b["device_ops"][0] == ["a", 2]
    assert b["idle_gaps"][0] == ["gpubench.to_host", 2] or b["idle_gaps"][0][1] == 2
    assert tr.kernel_name("void ns::foo_kernel<64, 2>(CUtensorMap, int)") == "foo_kernel"


def test_idle_share_is_the_device_busy_time_over_the_unprofiled_window():
    cfg, _ = _spec("deit_s_ibert")
    run = Run(cfg=cfg, traffic={}, batch=256, blocks=[], macs_per_image=1,
              img_per_s=256 / 0.020, enqueue_s=[])
    mod = cells.metric("idle_share")
    assert mod.read(run) is None
    # 2 profiled batches, 12 ms of device work each; the window ran a batch in 20 ms
    run.trace = _trace([("k", 0.0, 0.008), ("k", 0.008, 0.012), ("k", 0.05, 0.062)],
                       window=(0.0, 0.08), batches=2)
    assert mod.read(run) == pytest.approx(40.0)


def test_a_device_only_stretch_takes_its_window_from_the_host_wall():
    class Event:
        def __init__(self, name, dev, start, end):
            self.n, self.d, self.s, self.e = name, dev, start, end

        def name(self):
            return self.n

        def device_type(self):
            return f"DeviceType.{self.d}"

        def start_ns(self):
            return self.s

        def end_ns(self):
            return self.e

    class Prof:
        class profiler:
            class kineto_results:
                events = staticmethod(lambda: [Event("k", "CUDA", 2_000, 5_000),
                                               Event("Memcpy DtoH", "CUDA", 6_000, 7_000)])

    t = tr.from_profiler(Prof, 1, wall=10e-6)
    assert t.window == pytest.approx((2e-6, 12e-6))
    assert t.busy_s() == pytest.approx(4e-6)
    with pytest.raises(RuntimeError):
        tr.from_profiler(Prof, 1)


def test_roofline_reader_reads_only_whole_forwards():
    cfg, _ = _spec("deit_s_ibert")
    run = Run(cfg=cfg, traffic={}, batch=256, blocks=vit.blocks(cfg, 256),
              macs_per_image=vit.macs_per_image(cfg), img_per_s=1.0, enqueue_s=[])
    mod = cells.metric("mlp_block_roofline")
    per_call = 0.5e-3
    run.trace = _trace([(f"void mlp_wgmma_kernel<64>(x)", i, i + per_call) for i in range(24)],
                       window=(0, 30), batches=2)
    bound = roofline.bound_s(*mlp_block.calls(run.blocks)[0])
    assert mod.read(run) == pytest.approx(100 * bound / per_call)
    run.trace = _trace([("void mlp_wgmma_kernel<64>(x)", i, i + 1e-3) for i in range(23)],
                       window=(0, 30), batches=2)
    assert mod.read(run) is None
    run.trace = None
    assert mod.read(run) is None
    assert cells.metric("mfu").read(run) is None
