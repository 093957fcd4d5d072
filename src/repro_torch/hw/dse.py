"""Hardware-aware design space exploration (paper §VII; port of
`repro.hw.dse`).

The co-design loop:
  1. a compression sweep gives candidate `CompressionPlan`s (per-layer
     method x word length x rank), each with its quality and, in
     `plan.meta`, its compression ratio and NOps;
  2. hardware-aware pruning: a layer no engine of the platform can run
     (a launch the kernels refuse, a working set beyond the FPGA's
     resources) drops its candidate;
  3. each candidate's layers take their lowest-latency engine, summed
     into a (quality, latency) design point; the Pareto front returns.

Every `DesignPoint` carries the plan it was scored from, so a winner
deploys directly: `CompressionPlan.from_design_point(dp)` -> JSON ->
`InferenceEngine.build`.

Platforms:
  platform="h100"   -> hw/h100_model (the deployed card; the default)
  platform="zcu111" -> hw/engine_model (the paper's FPGA, as published)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

from repro_torch.hw import engine_model as em
from repro_torch.hw import h100_model as hm

PLATFORMS = ("h100", "zcu111")


@dataclasses.dataclass
class LayerShape:
    name: str
    k: int
    n: int
    rank: int | None = None     # None -> dense/quant-only
    wl: int | None = None       # per-layer weight word length override


@dataclasses.dataclass
class DesignPoint:
    label: str
    quality: float
    latency: float              # seconds (h100) or cycles (zcu111)
    compression_ratio: float
    nops: float
    per_layer: list
    plan: Any = None            # the api.plan.CompressionPlan evaluated


def model_layers_from_report(report) -> list:
    """LayerShape list from a core.compress CompressionReport."""
    out = []
    for lr in report.layers:
        k, n = lr.shape[-2], lr.shape[-1]
        mult = lr.shape[0] if len(lr.shape) == 3 else 1
        for i in range(mult):
            out.append(LayerShape(f"{lr.path}[{i}]" if mult > 1 else lr.path,
                                  k, n, lr.rank, wl=lr.wl))
    return out


def layer_shapes_from_plan(plan, params) -> list:
    """LayerShape list (stacks expanded) for a plan's active layers."""
    from repro_torch.core.compress import param_leaves_by_path

    leaves = param_leaves_by_path(params)
    out = []
    for lp in plan.active_layers():
        leaf = leaves[lp.path]
        k, n = int(leaf.shape[-2]), int(leaf.shape[-1])
        mult = 1
        for d in leaf.shape[:-2]:
            mult *= int(d)
        rank = None if lp.rank is None else min(int(lp.rank), min(k, n))
        for i in range(mult):
            out.append(LayerShape(
                f"{lp.path}[{i}]" if mult > 1 else lp.path,
                k, n, rank, wl=lp.wl))
    return out


def total_latency_h100(layers: Sequence[LayerShape], batch_m: int, *,
                       weight_wl: int = 8, bw_scale: float = 1.0,
                       engines=hm.ENGINES):
    """Sum of per-layer best-engine latencies on the H100 model, and the
    choices as (name, engine, seconds, config). A layer's own wl
    overrides `weight_wl`. `engines` restricts what a low-rank layer may
    run on; a dense layer has one engine, `baseline`, and takes it
    whatever `engines` says (the reference drops such a plan instead)."""
    total = 0.0
    chosen = []
    for l in layers:
        p = hm.best_point(batch_m, l.k, l.n, l.rank,
                          weight_wl=l.wl or weight_wl,
                          hbm_bw=hm.HBM_BW * bw_scale,
                          engines=engines if l.rank is not None
                          else ("baseline",))
        if p is None:
            return None, []
        total += p.latency_s
        chosen.append((l.name, p.kind, p.latency_s, p.config))
    return total, chosen


def total_latency_zcu111(layers: Sequence[LayerShape], batch_m: int, *,
                         weight_wl: int = 8, bw_bits_per_cycle=None):
    """Per-layer best engine under ZCU111 resources (paper platform)."""
    plat = dict(em.ZCU111)
    if bw_bits_per_cycle is not None:
        plat["offchip_bits_per_cycle"] = bw_bits_per_cycle
    total = 0.0
    chosen = []
    for l in layers:
        pts = em.explore(batch_m, l.k, l.n, l.rank,
                         weight_wl=l.wl or weight_wl)
        pts = [p for p in pts
               if p.bandwidth <= plat["offchip_bits_per_cycle"]]
        if not pts:
            return None, []
        best = min(pts, key=lambda p: p.latency_cycles)
        total += best.latency_cycles
        chosen.append((l.name, best.kind, best.latency_cycles, best.config))
    return total, chosen


def pareto(points: Sequence[DesignPoint]) -> list:
    """Upper-left front: max quality, min latency."""
    pts = sorted(points, key=lambda p: (p.latency, -p.quality))
    front, best_q = [], -float("inf")
    for p in pts:
        if p.quality > best_q:
            front.append(p)
            best_q = p.quality
    return front


def co_design(
    candidates: Sequence,
    quality_fn: Callable[[Any], float],
    layers_fn: Callable[[Any], Sequence[LayerShape]] | None = None,
    *,
    params=None,
    batch_m: int = 512,
    platform: str = "h100",
    bw_scale: float = 1.0,
) -> list:
    """The paper's §VII loop over `CompressionPlan` candidates.

    quality_fn(plan) is the calibration metric; layers_fn(plan) gives the
    layer shapes, ranks and wls the latency model prices (default:
    `layer_shapes_from_plan` against `params`). A plan's meta may carry
    "ratio" and "nops" (copied into its DesignPoint) and
    "engines_allowed" (restricts the H100 engine search of its low-rank
    layers). Returns the Pareto front; each point carries its plan for
    deployment.

    One divergence from `repro.hw.dse.co_design` (ROADMAP C4): a dense
    layer is priced on `baseline` whatever "engines_allowed" says, where
    the reference drops a plan whose dense layers the list excludes. So a
    low-rank plan with a quant lm head and ("cascade",) stays on the
    front here, and the two packages can return different fronts for the
    same candidates."""
    from repro_torch.api.plan import CompressionPlan

    if platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got "
                         f"{platform!r}")
    if layers_fn is None:
        if params is None:
            raise ValueError("co_design needs layers_fn or params")
        layers_fn = lambda plan: layer_shapes_from_plan(plan, params)  # noqa: E731

    points = []
    for plan in candidates:
        if not isinstance(plan, CompressionPlan):
            raise TypeError(
                f"co_design candidates must be CompressionPlans, got "
                f"{type(plan).__name__} (build one with "
                f"CompressionPlan.uniform / from_config)")
        q = quality_fn(plan)
        layers = list(layers_fn(plan))
        meta = getattr(plan, "meta", {}) or {}
        if platform == "h100":
            lat, chosen = total_latency_h100(
                layers, batch_m, bw_scale=bw_scale,
                engines=tuple(meta.get("engines_allowed", hm.ENGINES)))
        else:
            lat, chosen = total_latency_zcu111(layers, batch_m)
        if lat is None:
            continue
        points.append(DesignPoint(
            label=getattr(plan, "label", "") or str(plan),
            quality=q, latency=lat,
            compression_ratio=float(meta.get("ratio", 0.0)),
            nops=float(meta.get("nops", 0.0)),
            per_layer=chosen, plan=plan))
    return pareto(points)
