"""Per-layer compression plans (port of `repro.api.plan`).

The same JSON schema as the reference, so a `plan.json` written by either
package loads in the other, speculative-draft settings (`draft`, a
`runtime.speculation.DraftSpec`) included. `from_design_point` turns a
`hw.dse.DesignPoint` into the plan it scored, which closes the DSE ->
deployment loop; `merge_plans` overrides a plan's entries by path.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable

from repro_torch.runtime.speculation import DraftSpec

METHODS = ("none", "quant", "svd", "itera")
_LOWRANK = ("svd", "itera")
PLAN_FORMAT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Compression decision for one tree weight (a stacked (L, K, N) leaf
    counts as one path; rank and wl apply to every slice)."""

    path: str
    method: str = "quant"       # none | quant | svd | itera
    wl: int = 8
    rank: int | None = None

    def to_dict(self) -> dict:
        d = {"path": self.path, "method": self.method, "wl": self.wl}
        if self.rank is not None:
            d["rank"] = int(self.rank)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LayerPlan":
        return cls(path=str(d["path"]), method=str(d.get("method", "quant")),
                   wl=int(d.get("wl", 8)),
                   rank=None if d.get("rank") is None else int(d["rank"]))


@dataclasses.dataclass(frozen=True)
class CompressionPlan:
    """Ordered per-layer decisions plus activation-side settings."""

    layers: tuple = ()
    act_wl: int = 8
    power_iters: int = 24
    label: str = ""
    pack: bool = True
    # self-speculative decoding: the draft is this plan's own cascade
    # truncated per the spec (the useful depth depends on the plan's
    # ranks). None serves without speculation unless build(speculate=)
    # asks for it.
    draft: DraftSpec | None = None
    meta: dict = dataclasses.field(default_factory=dict)

    def __iter__(self):
        return iter(self.layers)

    def __len__(self) -> int:
        return len(self.layers)

    def by_path(self) -> dict:
        return {lp.path: lp for lp in self.layers}

    def active_layers(self) -> tuple:
        return tuple(lp for lp in self.layers if lp.method != "none")

    def replace(self, **kwargs) -> "CompressionPlan":
        return dataclasses.replace(self, **kwargs)

    # ----------------------------------------------------- serialization --
    def to_dict(self) -> dict:
        d = {"format_version": PLAN_FORMAT_VERSION, "label": self.label,
             "act_wl": self.act_wl, "pack": self.pack,
             "power_iters": self.power_iters,
             "layers": [lp.to_dict() for lp in self.layers],
             "meta": self.meta}
        if self.draft is not None:
            d["draft"] = self.draft.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CompressionPlan":
        v = int(d.get("format_version", PLAN_FORMAT_VERSION))
        if v > PLAN_FORMAT_VERSION:
            raise ValueError(f"plan format_version {v} is newer than "
                             f"supported {PLAN_FORMAT_VERSION}")
        return cls(
            layers=tuple(LayerPlan.from_dict(l) for l in d.get("layers", ())),
            act_wl=int(d.get("act_wl", 8)), pack=bool(d.get("pack", True)),
            power_iters=int(d.get("power_iters", 24)),
            label=str(d.get("label", "")),
            draft=(None if d.get("draft") is None
                   else DraftSpec.from_dict(d["draft"])),
            meta=dict(d.get("meta", {})))

    def dumps(self, *, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def loads(cls, text: str) -> "CompressionPlan":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps() + "\n")

    @classmethod
    def load(cls, path: str) -> "CompressionPlan":
        with open(path) as f:
            return cls.loads(f.read())

    # -------------------------------------------------------- validation --
    def validate(self, params=None) -> "CompressionPlan":
        """Check consistency and, given a param tree, that every path is a
        2-D+ weight with rank <= min(K, N). Returns self; raises
        ValueError on the first violation."""
        seen = set()
        for lp in self.layers:
            if lp.method not in METHODS:
                raise ValueError(f"{lp.path}: unknown method {lp.method!r} "
                                 f"(expected one of {METHODS})")
            if not 2 <= lp.wl <= 8:
                raise ValueError(f"{lp.path}: wl={lp.wl} outside [2, 8]")
            if lp.method in _LOWRANK and (lp.rank is None or lp.rank < 1):
                raise ValueError(f"{lp.path}: method {lp.method!r} needs a "
                                 f"positive rank, got {lp.rank}")
            if lp.method not in _LOWRANK and lp.rank is not None:
                raise ValueError(f"{lp.path}: rank={lp.rank} is meaningless "
                                 f"for method {lp.method!r}")
            if lp.path in seen:
                raise ValueError(f"duplicate plan entry for {lp.path}")
            seen.add(lp.path)
        if not 2 <= self.act_wl <= 8:
            raise ValueError(f"act_wl={self.act_wl} outside [2, 8]")
        if params is not None:
            from repro_torch.core.compress import flatten

            leaves = flatten(params)
            for lp in self.layers:
                if lp.path not in leaves:
                    raise ValueError(f"plan path {lp.path!r} not found in the "
                                     f"parameter tree")
                leaf = leaves[lp.path]
                if getattr(leaf, "ndim", 0) < 2:
                    raise ValueError(f"{lp.path}: not a 2-D+ weight")
                full = int(min(leaf.shape[-2:]))
                if lp.rank is not None and lp.rank > full:
                    raise ValueError(f"{lp.path}: rank {lp.rank} exceeds "
                                     f"min(K, N) = {full}")
        return self

    # ------------------------------------------------------ constructors --
    @classmethod
    def uniform(cls, params, *, method: str = "quant", weight_wl: int = 8,
                act_wl: int = 8, rank_fraction: float = 0.5,
                ranks: dict | None = None, label: str = "",
                power_iters: int = 24, **selection) -> "CompressionPlan":
        """One entry per eligible linear, all with the same method / wl
        (the uniform `CompressionConfig` semantics)."""
        from repro_torch.core.compress import CompressionConfig

        cfg = CompressionConfig(method=method, weight_wl=weight_wl,
                                act_wl=act_wl, rank_fraction=rank_fraction,
                                ranks=ranks, power_iters=power_iters,
                                **selection)
        return cls.from_config(params, cfg, label=label)

    @classmethod
    def from_config(cls, params, cfg, label: str = "") -> "CompressionPlan":
        from repro_torch.core.compress import eligible_linears

        entries = []
        for path, leaf in eligible_linears(params, cfg):
            kn = (int(leaf.shape[-2]), int(leaf.shape[-1]))
            rank = (cfg.rank_for(path, kn) if cfg.method in _LOWRANK
                    else None)
            entries.append(LayerPlan(path=path, method=cfg.method,
                                     wl=cfg.weight_wl, rank=rank))
        label = label or (f"{cfg.method}_W{cfg.weight_wl}"
                          if cfg.method != "none" else "none")
        return cls(layers=tuple(entries), act_wl=cfg.act_wl, pack=cfg.pack,
                   power_iters=cfg.power_iters, label=label).validate()

    @classmethod
    def from_design_point(cls, dp) -> "CompressionPlan":
        """The deployable plan of a `hw.dse.DesignPoint`: the candidate the
        DSE scored, relabelled with the point's provenance (quality,
        latency, each layer's engine), so the saved artifact describes
        itself."""
        plan = getattr(dp, "plan", None)
        if plan is None:
            raise ValueError(
                "DesignPoint carries no plan -- run hw.dse.co_design with "
                "CompressionPlan candidates")
        meta = dict(plan.meta)
        meta.update({
            "design_point": dp.label,
            "quality": float(dp.quality),
            "latency": float(dp.latency),
            "engines": [[name, kind] for name, kind, _, _ in dp.per_layer],
        })
        return plan.replace(label=dp.label or plan.label,
                            meta=meta).validate()

    def summary(self) -> str:
        from collections import Counter

        groups = Counter(f"{lp.method}_W{lp.wl}" for lp in self.layers)
        body = " ".join(f"{k}x{v}" for k, v in sorted(groups.items()))
        resid = "packed" if self.pack else "carrier"
        spec = ""
        if self.draft is not None:
            spec = (f", draft k={self.draft.k} "
                    f"r×{self.draft.rank_fraction:g}")
        return (f"plan[{self.label or 'unlabeled'}] {len(self.layers)} "
                f"layers: {body} (A{self.act_wl}, {resid}{spec})")


def merge_plans(base: CompressionPlan,
                overrides: Iterable[LayerPlan]) -> CompressionPlan:
    """A copy of `base` with `overrides` replacing its entries of the same
    path (order kept; overrides of other paths are appended)."""
    by_path = {lp.path: lp for lp in overrides}
    out = [by_path.pop(lp.path, lp) for lp in base.layers]
    out.extend(by_path.values())
    return base.replace(layers=tuple(out))
