"""Whole-model post-training compression (port of `repro.core.compress`).

Walks a parameter tree (nested dicts of tensors, paths "a/b/c" as in the
reference), replaces each weight a `CompressionPlan` (or a uniform
`CompressionConfig`) names with a `QuantizedTensor` or `LowRankQ`, and
reports resident storage bits and the paper's NOps per row. Methods
(paper §VIII-C): `quant` (WxAy quantization), `svd` (one-shot truncated
SVD, then quantization) and `itera` (Algorithm 1); per-layer ranks may
come from SRA (`core.sra`, through `sra_eval_closure`). Stacked (L, K, N)
leaves compress slice by slice in one batch. Runs on the device the
weights lie on.

Eligible linears are listed in the reference's order (jax flattens a dict
by sorted key), so a plan lowered from a config, and the layer order SRA
allocates over, are the same in both packages.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.itera import LowRankQ, itera_decompose, svd_decompose
from repro_torch.core.quant import QuantizedTensor, pack_weights, quantize


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Uniform compression: one global method / word length, per-layer
    rank override; lowered to a per-layer plan (`CompressionPlan.uniform`)."""

    method: str = "quant"              # none | quant | svd | itera
    weight_wl: int = 8
    act_wl: int = 8
    pack: bool = True                  # pack W4 weights two nibbles per byte
    rank_fraction: float = 0.5         # uniform rank = frac · min(K, N)
    ranks: dict | None = None          # per-layer override, e.g. from SRA
    min_rank: int = 1
    include: str = r".*"               # regex over tree paths
    exclude: str = r"(embed|router|norm|scale|bias|ln|pos)"
    min_dim: int = 32                  # skip tiny matrices
    power_iters: int = 24
    rank_multiple: int = 64            # aligned ranks for big matrices

    def rank_for(self, path: str, shape) -> int:
        full = min(int(shape[0]), int(shape[1]))
        if self.ranks and path in self.ranks:
            r = int(self.ranks[path])
        else:
            r = int(round(self.rank_fraction * full))
        if full >= 4 * self.rank_multiple:
            r = max(self.rank_multiple,
                    (r // self.rank_multiple) * self.rank_multiple)
        return max(self.min_rank, min(r, full))

    def to_plan(self, params):
        from repro_torch.api.plan import CompressionPlan

        return CompressionPlan.from_config(params, self)


@dataclasses.dataclass
class LayerReport:
    path: str
    shape: tuple
    method: str
    rank: int | None
    bits: int                  # RESIDENT bits: what the tensors occupy
    fp32_bits: int
    nops_per_row: int
    dense_nops_per_row: int
    wl: int = 8
    packed: bool = False


@dataclasses.dataclass
class CompressionReport:
    layers: list
    skipped_params: int        # element count of params left uncompressed
    plan: Any = None           # the executed api.plan.CompressionPlan
    skipped_bits: int = 0

    @property
    def compression_ratio(self) -> float:
        """FP32 bits over resident bits of the compressed layers."""
        comp = sum(l.bits for l in self.layers)
        return sum(l.fp32_bits for l in self.layers) / max(comp, 1)

    @property
    def nops_per_row(self) -> int:
        return sum(l.nops_per_row for l in self.layers)

    @property
    def dense_nops_per_row(self) -> int:
        return sum(l.dense_nops_per_row for l in self.layers)

    def summary(self) -> str:
        saved = 1 - self.nops_per_row / max(self.dense_nops_per_row, 1)
        return (f"layers={len(self.layers)} "
                f"packed={sum(1 for l in self.layers if l.packed)} "
                f"ratio={self.compression_ratio:.2f}x "
                f"NOps={self.nops_per_row / 1e6:.2f}M/row "
                f"({100 * saved:.1f}% saved)")


def flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} over a tree of dicts ("a/b/c"); compressed nodes
    (QuantizedTensor, LowRankQ) are leaves."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, p))
        else:
            out[p] = v
    return out


def param_leaves_by_path(params) -> dict:
    """{path: leaf} for every leaf of the tree, keyed by the reference's
    path strings (plan validation, the DSE's layer shapes)."""
    return flatten(params)


def map_with_path(fn, tree, prefix: str = ""):
    """A copy of the dict tree with fn(path, leaf) applied to each leaf."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        out[k] = map_with_path(fn, v, p) if isinstance(v, dict) else fn(p, v)
    return out


def eligible_linears(params, cfg: CompressionConfig) -> list:
    """(path, leaf) for every 2-D+ weight the config selects, in the
    reference's order (dict keys sorted at every level)."""
    inc, exc = re.compile(cfg.include), re.compile(cfg.exclude, re.I)
    out = []
    leaves = sorted(flatten(params).items(), key=lambda kv: kv[0].split("/"))
    for p, leaf in leaves:
        if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
            continue
        if min(leaf.shape[-2:]) < cfg.min_dim:
            continue
        if not inc.search(p) or exc.search(p):
            continue
        out.append((p, leaf))
    return out


def shape_spectra(params, alpha: float = 2.0,
                  selector: CompressionConfig | None = None):
    """Impose a power-law singular-value spectrum (s_i ∝ i^-alpha) on every
    weight the selector picks, keeping each matrix's singular vectors and
    Frobenius norm.

    Proxy conditioning, not compression: random-init weights have
    near-flat spectra, so truncating any rank discards components as
    informative as those kept -- nothing like the trained weights the
    paper compresses, whose spectra decay. Measurements of rank-truncation
    trade-offs (a draft's accept rate, SRA's allocation) shape the proxy
    first.

    Runs on the host in numpy float64, the reference's own code, so it
    gives the reference's bits; each shaped leaf goes back to its device
    and dtype. Stacked leaves (L, K, N) are shaped per matrix; leaves the
    selector excludes pass through untouched."""
    if alpha < 0:
        raise ValueError(f"alpha must be >= 0, got {alpha}")
    sel = selector if selector is not None else CompressionConfig()
    targets = {}
    for p, w in eligible_linears(params, sel):
        wn = w.detach().to("cpu", torch.float64).numpy()
        u, s, vt = np.linalg.svd(wn, full_matrices=False)
        t = np.arange(1, s.shape[-1] + 1, dtype=np.float64) ** -alpha
        t = t * (np.linalg.norm(s, axis=-1, keepdims=True)
                 / np.linalg.norm(t))
        shaped = torch.from_numpy((u * t[..., None, :]) @ vt)
        targets[p] = shaped.to(w.dtype).to(w.device)
    return map_with_path(lambda p, x: targets.get(p, x), params)


def _runtime_format(node, act_wl: int, pack: bool):
    """Stamp the plan's runtime knobs on a compressed node: the activation
    word length of its matmul and, for packable W4, the packed layout."""
    def one(q: QuantizedTensor) -> QuantizedTensor:
        q = dataclasses.replace(q, act_wl=act_wl)
        return pack_weights(q) if pack else q

    if isinstance(node, LowRankQ):
        return LowRankQ(one(node.w1), one(node.w2))
    return one(node)


def _compress_matrix(w: torch.Tensor, lp, power_iters: int, *,
                     act_wl: int = 8, pack: bool = True):
    """Compress one (..., K, N) weight per its LayerPlan -> (node, report)."""
    k, n = int(w.shape[-2]), int(w.shape[-1])
    rank = min(int(lp.rank), min(k, n)) if lp.rank is not None else None
    if lp.method == "quant":
        # scales shared along K of every (K, N) slice; axis stays 0, the
        # slice's own axis, as the reference's vmapped node records it
        node = dataclasses.replace(quantize(w, lp.wl, axis=w.ndim - 2),
                                   axis=0)
    elif lp.method == "svd":
        node = svd_decompose(w, rank, lp.wl)
    elif lp.method == "itera":
        node = itera_decompose(w, rank, lp.wl, power_iters=power_iters)
    else:
        raise ValueError(lp.method)
    mult = 1
    for d in w.shape[:-2]:
        mult *= int(d)
    node = _runtime_format(node, act_wl, pack)
    packed = (node.w1.packed or node.w2.packed if isinstance(node, LowRankQ)
              else node.packed)
    nops = k * n * mult if lp.method == "quant" else rank * (k + n) * mult
    return node, LayerReport(
        path=lp.path, shape=(mult, k, n) if mult > 1 else (k, n),
        method=lp.method, rank=None if lp.method == "quant" else rank,
        bits=node.storage_bits(), fp32_bits=32 * k * n * mult,
        nops_per_row=nops, dense_nops_per_row=k * n * mult, wl=lp.wl,
        packed=packed)


def compress_params(params, spec):
    """Execute a compression spec over a parameter tree: a
    `CompressionPlan` (per-layer method / wl / rank) or a uniform
    `CompressionConfig` (lowered to a plan first; method "none" returns
    the tree as it is). Returns (compressed tree, CompressionReport); the
    report's `.plan` is the executed plan."""
    from repro_torch.api.plan import CompressionPlan

    if not isinstance(spec, CompressionPlan):
        if spec.method == "none":
            leaves = [x for x in flatten(params).values()
                      if isinstance(x, torch.Tensor)]
            return params, CompressionReport(
                [], sum(x.numel() for x in leaves),
                plan=CompressionPlan(label="none", act_wl=spec.act_wl),
                skipped_bits=sum(_leaf_bits(x) for x in leaves))
        plan = spec.to_plan(params)
    else:
        plan = spec.validate(params)
    targets = {lp.path: lp for lp in plan.active_layers()}
    reports: list[LayerReport] = []
    skipped = skipped_bits = 0

    def visit(path, leaf):
        nonlocal skipped, skipped_bits
        if path in targets:
            node, rep = _compress_matrix(leaf, targets[path],
                                         plan.power_iters,
                                         act_wl=plan.act_wl, pack=plan.pack)
            reports.append(rep)
            return node
        if isinstance(leaf, torch.Tensor):
            skipped += leaf.numel()
            skipped_bits += _leaf_bits(leaf)
        return leaf

    new_params = map_with_path(visit, params)
    return new_params, CompressionReport(reports, skipped, plan=plan,
                                         skipped_bits=skipped_bits)


def _leaf_bits(leaf: torch.Tensor) -> int:
    """Actual storage bits of an uncompressed leaf (dtype itemsize)."""
    return leaf.numel() * leaf.element_size() * 8


def sra_eval_closure(params, cfg: CompressionConfig,
                     quality_fn: Callable[[Any], float]):
    """Bridge to `core.sra`: returns (eval_fn(ranks) -> quality, layer
    paths, max ranks). Each evaluation compresses the whole tree with
    `cfg` and the allocation as per-layer rank overrides (aligned by
    `rank_for`), then runs `quality_fn(compressed params)`, the
    calibration pass."""
    targets = eligible_linears(params, cfg)
    paths = [p for p, _ in targets]
    max_ranks = [int(min(w.shape[-2:])) for _, w in targets]

    def eval_fn(ranks):
        rmap = dict(zip(paths, [int(r) for r in ranks]))
        c = dataclasses.replace(cfg, ranks=rmap)
        cp, _ = compress_params(params, c)
        return float(quality_fn(cp))

    return eval_fn, paths, max_ranks
