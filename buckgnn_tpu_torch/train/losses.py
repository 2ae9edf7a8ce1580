"""The loss registry (port of buckgnn_tpu/train/losses.py:25-490).

Two calling conventions, as the trainer calls them:

- *flat* losses (buckling and the static node losses): ``loss(pred,
  target, mask)`` with a validity mask over the leading dim (the mask
  broadcasts over trailing components);
- the *graph family* (node-level, `GRAPH_FAMILY`): ``loss(pred, target,
  node_graph, node_mask, graph_mask, x)``, per-graph reductions by
  segment sums.

Masked rows and graphs contribute exactly zero. `get_loss_function` maps
the 27 names of the reference's registry (Utils/Losses.py:8-66).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from buckgnn_tpu_torch.ops import segment

__all__ = ["get_loss_function", "GRAPH_FAMILY", "STATIC_FAMILY"]


def _seg_sum(data, segment_ids, num_segments):
    """Per-graph sums by the one-hot product (ops/segment.py)."""
    return segment.segment_sum_dense(data, segment_ids, num_segments)


def _bcast(m, v):
    while m.ndim < v.ndim:
        m = m[..., None]
    return m


def _masked_mean_strict(v, mask):
    """Mean of v over the elements whose leading-dim mask is True; each
    valid row contributes all its trailing components."""
    m = mask.to(v.dtype)
    trailing = math.prod(v.shape[mask.ndim:])
    return (v * _bcast(m, v)).sum() / torch.clamp_min(m.sum() * trailing,
                                                      1.0)


# ---- flat losses ---------------------------------------------------------

def mse_loss(pred, target, mask):
    return _masked_mean_strict((pred - target) ** 2, mask)


def relative_error_loss(pred, target, mask, epsilon=1e-8):
    """The buckling default (RelativeErrorLoss, Losses.py:755-761)."""
    return _masked_mean_strict(
        torch.abs(pred - target) / (torch.abs(target) + epsilon), mask)


def log_cosh_loss(pred, target, mask):
    """log(cosh(x)) in its stable form (Losses.py:763-765)."""
    x = torch.abs(pred - target)
    v = x + torch.log1p(torch.exp(-2.0 * x)) - math.log(2.0)
    return _masked_mean_strict(v, mask)


def eigenvalue_loss(pred, target, mask, alpha=0.5, beta=0.5):
    """(Losses.py:767-776)."""
    return alpha * mse_loss(pred, target, mask) + beta * relative_error_loss(
        pred, target, mask)


def order_preserving_loss(pred, target, mask):
    """MSE + a pairwise ranking hinge over valid pairs (Losses.py:778-782)."""
    mse = mse_loss(pred, target, mask)
    dp = pred[:, None] - pred[None, :]
    dt = target[:, None] - target[None, :]
    pair = (mask[:, None] & mask[None, :]).to(pred.dtype)
    order = (torch.clamp_min(-(dp * dt), 0.0) * pair).sum() / torch.clamp_min(
        pair.sum(), 1.0)
    return mse + order


def mape_loss(pred, target, mask):
    """The reference's live MAPE class is plain MAE (Losses.py:883-890)."""
    return _masked_mean_strict(torch.abs(target - pred), mask)


def mae_loss(pred, target, mask):
    """The reference's MAE class computes squared error (Losses.py:697-722)."""
    return _masked_mean_strict(torch.abs(pred - target) ** 2, mask)


def rrse_loss(pred, target, mask):
    """sqrt(mean(err^2) / sum(y^2)) (Losses.py:915-921)."""
    m = mask.to(pred.dtype)
    num = _masked_mean_strict((pred - target) ** 2, mask)
    den = ((target ** 2) * _bcast(m, target)).sum()
    return torch.sqrt(num / den)


def rrse1_loss(pred, target, mask):
    """sqrt(mean(err^2 / y^2)) (Losses.py:925-931)."""
    return torch.sqrt(
        _masked_mean_strict((pred - target) ** 2 / (target ** 2), mask))


def msle_loss(pred, target, mask, epsilon=1e-8):
    """(Losses.py:168-203)."""
    lp = torch.log1p(torch.clamp_min(pred, 0.0) + epsilon)
    lt = torch.log1p(torch.clamp_min(target, 0.0) + epsilon)
    return _masked_mean_strict((lp - lt) ** 2, mask)


class RSELoss:
    """sqrt(mean(err^2) / mean((y - y_mean_train)^2)) (Losses.py:902-912)."""

    def __init__(self, values, epsilon=1e-8):
        self.y_mean = float(np.mean(np.asarray(values)))
        self.epsilon = epsilon

    def __call__(self, pred, target, mask):
        num = _masked_mean_strict((pred - target) ** 2, mask)
        den = _masked_mean_strict((target - self.y_mean) ** 2,
                                  mask) + self.epsilon
        return torch.sqrt(num / den)


class FocalLossRegression:
    """Histogram-weighted focal regression loss (Losses.py:784-862): bin
    weights from the training targets at construction (inverse smoothed
    frequency, empty bins filled from the left, a 9-tap smoothing at 100
    bins or more), an out-of-range prediction weighted by the penalty."""

    def __init__(self, values, alpha=1.0, gamma=2.0, num_bins=10,
                 penalty_factor=2.0):
        self.alpha = alpha
        self.gamma = gamma
        self.num_bins = num_bins
        self.penalty_factor = penalty_factor
        values = np.asarray(values, dtype=np.float32).reshape(-1)
        self.min_val = float(values.min())
        self.max_val = float(values.max())
        hist, bin_edges = np.histogram(values, bins=num_bins,
                                       range=(self.min_val, self.max_val))
        freq = hist.astype(np.float64) / len(values)
        for idx in np.where(hist == 0)[0]:
            if idx:
                freq[idx] = freq[idx - 1]
        weights = 1.0 / (freq + 1.0)
        weights = weights / weights.sum()
        if num_bins > 99:
            k = 9
            wpad = np.pad(weights, k // 2, mode="reflect")
            weights = np.convolve(wpad, np.ones(k) / k, mode="valid")
        self.bin_edges = torch.as_tensor(bin_edges, dtype=torch.float32)
        self.weights = torch.as_tensor(weights, dtype=torch.float32)

    def _bin_weights(self, target):
        edges = self.bin_edges.to(target.device)
        idx = torch.searchsorted(edges[1:], target.contiguous(),
                                 right=True) - 1
        idx = idx.clamp(0, self.num_bins - 1)
        return self.weights.to(target.device)[idx]

    def _weights_for(self, pred, target):
        w = self._bin_weights(target)
        oob = (pred < self.min_val) | (pred > self.max_val)
        return torch.where(oob, torch.full_like(w, self.penalty_factor), w)

    def __call__(self, pred, target, mask):
        v = self._weights_for(pred, target) * torch.abs(
            pred - target) ** self.gamma
        return self.alpha * _masked_mean_strict(v, mask)


class FocalRRSE(FocalLossRegression):
    """(Losses.py:933-956): the scalar RRSE weighted per sample."""

    def __init__(self, values, alpha=1.0, gamma=2.0, num_bins=100,
                 penalty_factor=10, **kw):
        super().__init__(values, alpha, gamma, num_bins, penalty_factor)

    def __call__(self, pred, target, mask):
        m = mask.to(pred.dtype)
        err = torch.sqrt(_masked_mean_strict((pred - target) ** 2, mask)
                         / (target ** 2 * _bcast(m, target)).sum())
        w = self._bin_weights(target)
        oob = (pred < self.min_val) | (pred > self.max_val)
        w = torch.where(oob, w * self.penalty_factor, w)
        return self.alpha * _masked_mean_strict(w * err ** self.gamma, mask)


class FocalMAPE(FocalLossRegression):
    """(Losses.py:959-983): the scalar masked MAPE weighted per sample."""

    def __call__(self, pred, target, mask):
        err = _masked_mean_strict(
            torch.abs(pred - target) / (torch.abs(target) + 1e-8), mask)
        w = self._weights_for(pred, target)
        return self.alpha * _masked_mean_strict(w * err ** self.gamma, mask)


# ---- static node losses --------------------------------------------------

class StaticAnalysisLoss:
    """alpha * relative + (1 - alpha) * MSE (Losses.py:136-150)."""

    def __init__(self, alpha=0.5):
        self.alpha = alpha

    def __call__(self, pred, target, mask):
        rel = _masked_mean_strict(
            torch.abs((pred - target) / (target + 1e-8)), mask)
        return self.alpha * rel + (1 - self.alpha) * mse_loss(pred, target,
                                                              mask)


def static_mae_loss(pred, target, mask):
    """The L1 norm of the error (Losses.py:152-166)."""
    return (torch.abs(pred - target) * _bcast(mask.to(pred.dtype),
                                              pred)).sum()


class StaticFocalStressLoss:
    """MSE + focal + magnitude weighting over masked rows
    (Losses.py:205-243)."""

    def __init__(self, alpha=0.25, gamma=2.0):
        self.alpha = alpha
        self.gamma = gamma

    def __call__(self, pred, target, mask):
        m = _bcast(mask.to(pred.dtype), pred)
        err = torch.abs(target - pred)
        count = torch.clamp_min((m * torch.ones_like(pred)).sum(), 1.0)
        mse = (((target - pred) ** 2) * m).sum() / count
        focal = ((err ** self.gamma) * err * m).sum() / count
        weighted = ((torch.abs(target) + 1.0) * err * m).sum() / count
        return mse + self.alpha * (focal + weighted)


# ---- graph family --------------------------------------------------------

def _per_graph_mean(v, node_graph, node_mask, n_graphs):
    """Mean over each graph's valid node rows; v [N, C] -> [G]."""
    m = node_mask.to(v.dtype)
    num = _seg_sum(v.sum(-1) * m, node_graph, n_graphs)
    den = _seg_sum(m * v.shape[-1], node_graph, n_graphs)
    return num / torch.clamp_min(den, 1.0)


def _graphs_mean(per_graph, graph_mask):
    g = graph_mask.to(per_graph.dtype)
    return (per_graph * g).sum() / torch.clamp_min(g.sum(), 1.0)


def _total_force(x, node_graph, node_mask, n_graphs):
    """Per-graph total force magnitude; the forces are x[:, 3:5]
    (Losses.py:519-524)."""
    f = torch.linalg.norm(x[:, 3:5], dim=1) * node_mask.to(x.dtype)
    return _seg_sum(f, node_graph, n_graphs)


def _nanquantile_rows(mat, q):
    """Per-row quantile ignoring NaNs (linear interpolation); a row of NaNs
    gives 0."""
    out = torch.nanquantile(mat, q, dim=1)
    return torch.where(torch.isnan(out), torch.zeros_like(out), out)


def _members(node_graph, node_mask, n_graphs):
    return (node_graph[None, :].long() == torch.arange(
        n_graphs, device=node_graph.device)[:, None]) & node_mask[None, :]


class GraphLoss:
    """The graph_* family: a per-graph value, averaged over the valid
    graphs, times ``scale``."""

    scale = 10000.0

    def per_graph(self, pred, target, node_graph, node_mask, n_graphs, x):
        raise NotImplementedError

    def __call__(self, pred, target, node_graph, node_mask, graph_mask, x):
        n_graphs = graph_mask.shape[0]
        pg = self.per_graph(pred, target, node_graph, node_mask, n_graphs, x)
        return _graphs_mean(pg, graph_mask) * self.scale


class GraphMSELoss(GraphLoss):
    """mean(|pred^2 - target^2|) per graph (Losses.py:445-475)."""

    def per_graph(self, pred, target, node_graph, node_mask, n_graphs, x):
        return _per_graph_mean(torch.abs(pred ** 2 - target ** 2),
                               node_graph, node_mask, n_graphs)


class GraphMAELoss(GraphLoss):
    """(Losses.py:477-507)."""

    def per_graph(self, pred, target, node_graph, node_mask, n_graphs, x):
        return _per_graph_mean(torch.abs(pred - target), node_graph,
                               node_mask, n_graphs)


class GraphRelativeError(GraphLoss):
    """Mean relative error per graph, eps 0.1 (Losses.py:362-401)."""

    def per_graph(self, pred, target, node_graph, node_mask, n_graphs, x):
        rel = torch.abs(pred - target) / (torch.abs(target) + 0.1)
        return _per_graph_mean(rel, node_graph, node_mask, n_graphs)


class GraphMixedError:
    """0.2 * per-graph quantile(rel, 0.2) + 0.8 * per-graph MAE
    (Losses.py:403-443), the quantile over a [G, N] masked matrix."""

    def __init__(self, epsilon=1e-8, percentile=0.2):
        self.epsilon = epsilon
        self.percentile = percentile

    def __call__(self, pred, target, node_graph, node_mask, graph_mask, x):
        n_graphs = graph_mask.shape[0]
        rel = torch.abs(pred - target) / (torch.abs(target) + self.epsilon)
        member = _members(node_graph, node_mask, n_graphs)
        mat = torch.where(member, rel.mean(-1)[None, :],
                          torch.full((), float("nan"), dtype=rel.dtype,
                                     device=rel.device))
        q = _nanquantile_rows(mat, self.percentile)
        mae = _per_graph_mean(torch.abs(pred - target), node_graph,
                              node_mask, n_graphs)
        return (0.2 * _graphs_mean(q, graph_mask)
                + 0.8 * _graphs_mean(mae, graph_mask))


class GraphMaxComponentRelativeError(GraphLoss):
    """Relative error at each component's max-|target| node per graph
    (Losses.py:303-360)."""

    def per_graph(self, pred, target, node_graph, node_mask, n_graphs, x):
        ta = torch.where(node_mask[:, None], torch.abs(target),
                         torch.full((), -math.inf, dtype=target.dtype,
                                    device=target.device))
        seg_max = segment.segment_max(ta, node_graph, n_graphs)
        at_max = (ta == seg_max[node_graph.long()]) & node_mask[:, None]
        rel = torch.abs(pred - target) / (torch.abs(target) + 1e-8)
        num = _seg_sum(torch.where(at_max, rel, torch.zeros_like(rel)),
                       node_graph, n_graphs)
        den = _seg_sum(at_max.to(rel.dtype), node_graph, n_graphs)
        return (num / torch.clamp_min(den, 1.0)).mean(-1)


class _ScaledGraphLoss(GraphLoss):
    """Scaled by each graph's total force (Losses.py:509-695; per graph as
    intended, where the reference sums the whole batch's forces)."""

    scale = 100.0
    min_scale = 0.1

    def __call__(self, pred, target, node_graph, node_mask, graph_mask, x):
        n_graphs = graph_mask.shape[0]
        pg = self.per_graph(pred, target, node_graph, node_mask, n_graphs, x)
        force = _total_force(x, node_graph, node_mask, n_graphs)
        pg = pg * torch.clamp_min(force, self.min_scale)
        return _graphs_mean(pg, graph_mask) * self.scale


class ScaledGraphMAELoss(_ScaledGraphLoss):
    def per_graph(self, pred, target, node_graph, node_mask, n_graphs, x):
        return _per_graph_mean(torch.abs(pred - target), node_graph,
                               node_mask, n_graphs)


class ScaledGraphMSELoss(_ScaledGraphLoss):
    def per_graph(self, pred, target, node_graph, node_mask, n_graphs, x):
        return _per_graph_mean(torch.abs(pred ** 2 - target ** 2),
                               node_graph, node_mask, n_graphs)


class ScaledGraphRELoss(_ScaledGraphLoss):
    """The L1-norm relative error per graph (Losses.py:627-695)."""

    def per_graph(self, pred, target, node_graph, node_mask, n_graphs, x):
        m = node_mask.to(pred.dtype)[:, None]
        err = _seg_sum((torch.abs(pred - target) * m).sum(-1), node_graph,
                       n_graphs)
        tgt = _seg_sum((torch.abs(target) * m).sum(-1), node_graph,
                       n_graphs)
        return err / (tgt + 1e-8)


# ---- the registry --------------------------------------------------------

_FLAT = {
    "mse": mse_loss,
    "relative_error": relative_error_loss,
    "log_cosh": log_cosh_loss,
    "eigenvalue": eigenvalue_loss,
    "order_preserving": order_preserving_loss,
    "mape": mape_loss,
    "mae": mae_loss,
    "rrse": rrse_loss,
    "rrse1": rrse1_loss,
    "msle": msle_loss,
}
_GRAPH = {
    "graph_mse": GraphMSELoss,
    "graph_mae": GraphMAELoss,
    "graph_rel": GraphRelativeError,
    "graph_mixed": GraphMixedError,
    "graph_max_rel": GraphMaxComponentRelativeError,
    "graph_rel_scaled": ScaledGraphRELoss,
    "graph_mae_scaled": ScaledGraphMAELoss,
    "graph_mse_scaled": ScaledGraphMSELoss,
}
GRAPH_FAMILY = set(_GRAPH)
STATIC_FAMILY = {"static_mixed", "static_mse", "static_relative",
                 "static_stress", "static_mae"}
LOSS_NAMES = (*_FLAT, "rse", "focal", "focal_rrse", "focal_mape",
              *sorted(STATIC_FAMILY), *_GRAPH)


def get_loss_function(loss_name: str, all_values=None,
                      use_z_coord: bool = False,
                      use_rotations: bool = False):
    """The loss named ``loss_name`` (get_loss_function,
    Utils/Losses.py:8-66). ``all_values``: the training targets the
    histogram and RSE losses are built from."""
    if loss_name in _FLAT:
        return _FLAT[loss_name]
    if loss_name == "rse":
        return RSELoss(all_values)
    if loss_name == "focal":
        return FocalLossRegression(all_values, alpha=1.0, gamma=2.0,
                                   num_bins=100)
    if loss_name == "focal_rrse":
        return FocalRRSE(all_values, alpha=1.0, gamma=2.0, num_bins=100,
                         penalty_factor=10)
    if loss_name == "focal_mape":
        return FocalMAPE(all_values, alpha=1.0, gamma=2.0, num_bins=100)
    if loss_name == "static_mixed":
        return StaticAnalysisLoss(alpha=0.1)
    if loss_name == "static_mse":
        return StaticAnalysisLoss(alpha=0.0)
    if loss_name == "static_relative":
        return StaticAnalysisLoss(alpha=1.0)
    if loss_name == "static_stress":
        return StaticFocalStressLoss()
    if loss_name == "static_mae":
        return static_mae_loss
    if loss_name in _GRAPH:
        return _GRAPH[loss_name]()
    raise ValueError(f"Unknown loss function: {loss_name}")
