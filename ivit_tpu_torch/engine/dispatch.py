"""The engine's path choice (counterpart of ``ivit_tpu/engine/dispatch.py``).

The engine has bit-identical paths: the fused block kernels
(``kernels=True``), the standalone nonlinearity kernels inside the unfused
engine (``kernels="ops"``, ViT only) and the plain per-op engine
(``kernels=False``); a Swin engine may also fuse by stage
(``stage_paths``).  ``Engine(spec)`` leaves ``kernels=None`` and on the
card resolves it here:

* :func:`static_choice` (a ViT) and :func:`swin_stage_choice` (a Swin, per
  stage): tables of A/B measurements on the H100, each row with the card,
  its power limit, both paths' img/s and the ``PERF.md`` section that
  records them;
* :func:`timed_choice`: a one-time timed probe of both paths
  (``Engine(spec, probe_images=...)``).

Only paths that launch a kernel are candidates on the card
(:func:`unfused_candidate`): the fused kernels, and a ViT's ``"ops"`` where
its softmax or GELU is ivit.  An ibert, ppoly or float ViT and every Swin
have no such unfused path, so they keep the fused kernels (a Swin the
fused kernels on the stages of its table) and are not probed.

``ivit_tpu_torch/scripts/path_compare.py`` and ``swin_path_compare.py``
measure the rows.  A geometry the tables do not hold takes the fused
kernels (JAX's TPU fallback, "fused iff C >= 256", was fitted to another
device and is not carried over).  JAX's ``TUNED`` / ``kernel_tune`` pick
the TPU kernels' tiles; the port's kernels choose their blocks by shape,
so they have no counterpart here.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
_WHERE = "PERF.md section 6, the path dispatch's A/B"

# (arch, embed_dim) -> the faster path on the card: the fused block
# kernels, or for a ViT the standalone kernels (``kernels="ops"``).  ViT
# rows: ``python -m ivit_tpu_torch.scripts.path_compare --model M --fam F
# --batch 256 --iters 10 --modes blocks,ops,plain --passes 2 --check``
# (224 px, full depth); the Swin row: ``swin_path_compare --iters 15
# --passes 2 --check`` on Swin-T ivit at batch 64.  Pass 1 / pass 2.
MEASURED: Dict[Tuple[str, int], Dict[str, Any]] = {
    ("vit", 192): {"fused": True, "evidence": (
        f"{_CARD}: DeiT-T ivit blocks 19,263.7 / 19,450.5 img/s vs ops "
        f"1,676.1 / 1,616.8 img/s ({_WHERE})")},
    ("vit", 384): {"fused": True, "evidence": (
        f"{_CARD}: DeiT-S ivit blocks 11,920.4 / 12,004.2 img/s vs ops "
        f"986.9 / 960.9 img/s; ibert blocks 11,685.0 / 11,834.7 vs ops (the "
        f"plain engine for ibert) 610.3 / 596.5 img/s ({_WHERE})")},
    ("vit", 768): {"fused": True, "evidence": (
        f"{_CARD}: ViT-B ivit blocks 3,781.8 / 3,719.0 img/s vs ops "
        f"482.9 / 482.1 img/s ({_WHERE})")},
    ("swin", 96): {"fused": True, "evidence": (
        f"{_CARD}: Swin-T ivit fused 2,231.7 / 2,263.6 img/s vs unfused "
        f"235.0 / 229.3 img/s ({_WHERE})")},
}

# Swin stage width -> whether that stage runs the fused kernels: the same
# Swin-T run, each stage's pair of mixes that differ there alone
# (swin_path_compare.STAGE_PAIRS).
MEASURED_SWIN_STAGE: Dict[int, Dict[str, Any]] = {
    96: {"fused": True, "evidence": (
        f"{_CARD}: fused 2,231.7 / 2,263.6 img/s vs stages123 628.6 / "
        f"592.5 img/s ({_WHERE})")},
    192: {"fused": True, "evidence": (
        f"{_CARD}: stages123 628.6 / 592.5 img/s vs stages23 413.4 / "
        f"406.5 img/s ({_WHERE})")},
    384: {"fused": True, "evidence": (
        f"{_CARD}: stages23 413.4 / 406.5 img/s vs stages3 272.1 / "
        f"253.8 img/s ({_WHERE})")},
    768: {"fused": True, "evidence": (
        f"{_CARD}: stages3 272.1 / 253.8 img/s vs unfused 235.0 / "
        f"229.3 img/s ({_WHERE})")},
}


def _arch(cfg) -> str:
    return "swin" if hasattr(cfg, "depths") else "vit"


def _absent(key) -> str:
    return (f"the H100 tables hold no row for {key}: the fused kernels, "
            "the port's default")


def static_choice(cfg) -> Tuple[bool, Dict[str, Any]]:
    """Table lookup -> ``(use_fused, report)``; a geometry absent from the
    table takes the fused kernels (``source == "default"``)."""
    key = (_arch(cfg), int(cfg.embed_dim))
    row = MEASURED.get(key)
    if row is None:
        return True, {"source": "default", "key": str(key), "evidence": _absent(key)}
    return bool(row["fused"]), {"source": "static-table", "key": str(key),
                                "evidence": row["evidence"]}


def swin_stage_choice(cfg) -> Tuple[tuple, Dict[str, Any]]:
    """One bool a stage of a Swin config (fused or not), from
    :data:`MEASURED_SWIN_STAGE`; an absent stage width takes the fused
    kernels."""
    paths, evidence = [], {}
    for i in range(len(cfg.depths)):
        dim = int(cfg.embed_dim) * 2 ** i
        row = MEASURED_SWIN_STAGE.get(dim)
        paths.append(True if row is None else bool(row["fused"]))
        evidence[str(dim)] = _absent(("swin stage", dim)) if row is None else row["evidence"]
    return tuple(paths), {"source": "swin-stage-table", "evidence": evidence}


def timed_choice(fused_fn, unfused_fn, x, iters: int = 10):
    """One-time timed probe: each path called once warm, then ``iters``
    times between synchronizations of ``x``'s device
    (``utils.benchmarking.time_dispatch``); the fused path wins a tie.
    Returns ``(use_fused, report)``."""
    from ..utils.benchmarking import time_dispatch
    t_fused = time_dispatch(fused_fn, x, iters=iters)
    t_unfused = time_dispatch(unfused_fn, x, iters=iters)
    return t_fused <= t_unfused, {"source": "timed-probe",
                                  "t_fused_ms": round(t_fused * 1e3, 3),
                                  "t_unfused_ms": round(t_unfused * 1e3, 3)}


def _fams(cfg):
    return cfg.base_type("softmax"), cfg.base_type("gelu")


def unfused_candidate(cfg):
    """The unfused path that a probe or a table row may take on the card,
    or None: a ViT's ``"ops"`` where its softmax or GELU is ivit (the
    standalone kernels run there).  No other unfused path launches a kernel
    (``"ops"`` runs ibert, ppoly and float in plain ops; a Swin's unfused
    engine is the plain version), and the card's main path never runs
    the plain version."""
    if _arch(cfg) == "swin":
        return None
    return "ops" if "ivit" in _fams(cfg) else None


_NO_CANDIDATE = ("the fused kernels: no unfused path of this spec launches a "
                 "kernel on the card")


def resolve(cfg, probe=None):
    """The path ``Engine(spec)`` takes on the card for ``kernels=None``:
    ``(kernels, stage_paths, report)``.  ``probe``: ``(make, x)``, where
    ``make(kernels)`` is the engine's callable on that path, for
    :func:`timed_choice`; or None for the tables.

    Only a path that launches a kernel is taken.  Where no unfused path
    does (:func:`unfused_candidate`), the probe is skipped, the tables
    decide, and a row that says unfused keeps the fused kernels (the
    report's ``"note"``).  A ViT whose float softmax or GELU leaves the
    fused path without a block kernel takes ``"ops"`` where that launches
    the other ivit one."""
    other = unfused_candidate(cfg)
    if other is not None and "float" in _fams(cfg):
        return other, None, {"source": "families", "key": str(_fams(cfg)),
                             "evidence": "a float softmax or GELU has no block "
                                         "kernel: 'ops' launches the ivit one"}
    if probe is not None and other is not None:
        make, x = probe
        fused, report = timed_choice(make(True), make(other), x)
        return (True if fused else other), None, report
    if _arch(cfg) == "swin":
        kernels, (paths, report) = True, swin_stage_choice(cfg)
        if not any(paths):
            paths, report = None, {**report, "note": _NO_CANDIDATE}
    else:
        (fused, report), paths = static_choice(cfg), None
        kernels = True if fused or other is None else other
        if kernels is True and not fused:
            report = {**report, "note": _NO_CANDIDATE}
    if probe is not None:
        report = {**report, "probe": "skipped: " + _NO_CANDIDATE}
    return kernels, paths, report
