"""The system under test: ``ivit_tpu_torch.Engine`` on the benchmark's spec.

The only module of the benchmark that imports the program.  It wraps the
benchmark-made tree in the port's ``EngineSpec`` / ``SwinEngineSpec`` and
builds ``Engine(spec)`` with the port's defaults (``kernels=None``: the
card's path dispatch picks the path; no probe), and reads the program's
kernel-launch counters.
"""

from __future__ import annotations

# environment switches of the program that would move it off its defaults;
# the benchmark runs what a user gets without them
PROGRAM_SWITCHES = ("IVIT_LUT", "IVIT_XLA_LUT")


def engine_spec(cfg, params):
    """The benchmark's config dict and numpy tree as the port's spec."""
    from ivit_tpu_torch.engine.freeze import EngineConfig, EngineSpec
    from ivit_tpu_torch.engine.swin_int import SwinEngineConfig, SwinEngineSpec
    from ivit_tpu_torch.models.vit import BitWidths

    common = dict(img_size=cfg["img_size"], patch_size=cfg["patch_size"],
                  embed_dim=cfg["embed_dim"], mlp_ratio=cfg["mlp_ratio"],
                  num_classes=cfg["num_classes"],
                  bitwidths=BitWidths(**cfg["bits"]), gelu_type=cfg["gelu_type"],
                  softmax_type=cfg["softmax_type"],
                  layernorm_type=cfg["layernorm_type"], fast_exp=cfg["fast_exp"],
                  fast_poly=cfg["fast_poly"], use_lut=cfg["use_lut"],
                  sm_sum_i32=cfg["sm_sum_i32"], ppoly_fastdiv=cfg["ppoly_fastdiv"])
    if cfg["arch"] == "swin":
        config = SwinEngineConfig(
            depth=sum(cfg["depths"]), num_heads=cfg["stage_heads"][0],
            depths=tuple(cfg["depths"]), stage_heads=tuple(cfg["stage_heads"]),
            window_size=cfg["window_size"], layout=tuple(cfg["layout"]), **common)
        return SwinEngineSpec(config=config, params=params)
    config = EngineConfig(depth=cfg["depth"], num_heads=cfg["num_heads"], **common)
    return EngineSpec(config=config, params=params)


def build(cfg, params, device):
    """``Engine(spec)`` on ``device`` with every other argument its default
    (on the CPU the port's plain versions run)."""
    from ivit_tpu_torch.engine.vit_int import Engine

    return Engine(engine_spec(cfg, params), device=device)


def path_report(engine) -> dict:
    """The path the engine resolved, as it reports it."""
    return {"kernels": repr(engine.kernels),
            "path_choice": engine.fusion.get("path_choice", {})}
