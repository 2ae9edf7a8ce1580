"""Evaluation metrics (port of buckgnn_tpu/train/metrics.py:24-292).

`MAPE_error` for every prediction type and the node-level `stress_errors`
aggregates: masked segment reductions over the batch's graphs, summed
over the graphs as the reference sums them (the caller divides by its
graph count).
"""

from __future__ import annotations

import math

import torch

from buckgnn_tpu_torch.ops import segment

__all__ = ["MAPE_error", "stress_errors", "masked_mape"]


def _seg_sum(data, segment_ids, num_segments):
    return segment.segment_sum_dense(data, segment_ids, num_segments)


def masked_mape(pred, target, mask):
    """mean(|(t - p)/t|) * 100 over valid entries (Metrics.py:10-12)."""
    m = mask.to(pred.dtype)
    rel = torch.abs((target - pred) / target)
    return (rel * m).sum() / torch.clamp_min(m.sum(), 1.0) * 100.0


def MAPE_error(predictions, targets, mask, prediction_type: str = "buckling",
               eigen_scale=None, eigen_center=None, threshold: float = 0.1):
    """Metrics.MAPE_error parity (Metrics.py:4-23). ``mask``: the graph
    mask (buckling, denormalized with the eigenvalue scaler stats when
    given) or the node mask (the node-level types)."""
    if prediction_type == "buckling":
        if eigen_scale is not None:
            predictions = predictions * eigen_scale + eigen_center
            targets = targets * eigen_scale + eigen_center
        return masked_mape(predictions, targets, mask)
    if prediction_type in ("static_disp", "static_stress"):
        m = (torch.abs(targets) >= threshold) & mask[:, None]
        rel = torch.abs((targets - predictions) / (targets + 1e-8))
        return (rel * m).sum() / torch.clamp_min(m.sum(), 1.0) * 100.0
    if prediction_type == "mode_shape":
        pn = predictions / (torch.linalg.norm(predictions, dim=1,
                                              keepdim=True) + 1e-8)
        tn = targets / (torch.linalg.norm(targets, dim=1, keepdim=True)
                        + 1e-8)
        m = mask.to(pn.dtype)[:, None]
        return ((torch.abs(pn - tn) * m).sum()
                / torch.clamp_min(m.sum() * pn.shape[1], 1.0) * 100.0)
    raise ValueError(prediction_type)


def _seg_mean(v, ids, n, mask):
    m = mask.to(v.dtype)
    den = _seg_sum(m, ids, n)
    return _seg_sum(v * m, ids, n) / torch.clamp_min(den, 1.0), den


def _seg_masked_quantile(v, ids, n, mask, q):
    """Per-graph quantile over a [G, N] masked matrix (NaN outside); an
    empty graph gives 0."""
    member = (ids[None, :].long() == torch.arange(
        n, device=ids.device)[:, None]) & mask[None, :]
    mat = torch.where(member, v[None, :],
                      torch.full((), math.nan, dtype=v.dtype,
                                 device=v.device))
    out = torch.nanquantile(mat, q, dim=1)
    return torch.where(torch.isnan(out), torch.zeros_like(out), out)


def _neg_inf(like):
    return torch.full((), -math.inf, dtype=like.dtype, device=like.device)


def stress_errors(predictions, targets, node_graph, node_mask, graph_mask,
                  prediction_type: str = "static_stress",
                  threshold: float = 0.1) -> dict:
    """Per-graph error aggregates summed over the graphs
    (Metrics.py:25-191), with the reference's keys. Empty regions add 0."""
    n_graphs = graph_mask.shape[0]
    g = graph_mask.to(predictions.dtype)
    abs_diff = torch.abs(targets - predictions)
    rel_diff = abs_diff / (torch.abs(targets) + 1e-8)
    valid = node_mask
    vmask = valid[:, None]
    graph = node_graph.long()
    out = {}

    def add_region(suffix, rm):
        """mape / re / rmse / mae / p90 over a [N, C] region mask."""
        rmf = rm.to(predictions.dtype)
        cnt = _seg_sum(rmf.sum(-1), node_graph, n_graphs)
        has = (cnt > 0).to(predictions.dtype) * g

        def region_mean(v):
            return _seg_sum((v * rmf).sum(-1), node_graph,
                            n_graphs) / torch.clamp_min(cnt, 1.0)

        mape = region_mean(rel_diff) * 100.0
        re_num = _seg_sum((abs_diff * rmf).sum(-1), node_graph, n_graphs)
        re_den = _seg_sum((torch.abs(targets) * rmf).sum(-1), node_graph,
                          n_graphs)
        re = re_num / torch.clamp_min(re_den, 1e-8) * 100.0
        # sqrt(mean(t^2 - p^2)) as the reference (Metrics.py:81-82), the
        # negative means clamped to 0
        rmse = torch.sqrt(torch.clamp_min(
            region_mean(targets ** 2 - predictions ** 2), 0.0))
        mae = region_mean(abs_diff)
        # a row's mean over its components where the whole row lies in the
        # region; a partial row's NaN and an empty row become 0
        row_has = rm.any(-1)
        flat_rel = torch.where(rm, rel_diff, torch.full(
            (), math.nan, dtype=rel_diff.dtype,
            device=rel_diff.device)).mean(-1)
        p90 = _seg_masked_quantile(
            torch.where(row_has, torch.nan_to_num(flat_rel),
                        torch.zeros_like(flat_rel)),
            node_graph, n_graphs, valid & row_has, 0.9) * 100.0
        for k, v in (("mape", mape), ("re", re), ("rmse", rmse),
                     ("mae", mae), ("p90", p90)):
            out[f"{k}{suffix}"] = (v * has).sum()

    def max_components(names):
        """The value, MAE and relative error at each component's
        max-|target| node."""
        ta = torch.where(vmask, torch.abs(targets), _neg_inf(targets))
        seg_max = segment.segment_max(ta, node_graph, n_graphs)
        at_max = (ta == seg_max[graph]) & vmask
        den = _seg_sum(at_max.to(ta.dtype), node_graph, n_graphs)
        for i, comp in enumerate(names):
            sel = at_max[:, i].to(ta.dtype)
            d = torch.clamp_min(den[:, i], 1.0)
            val = _seg_sum(torch.abs(targets[:, i]) * sel, node_graph,
                           n_graphs) / d
            mae = _seg_sum(abs_diff[:, i] * sel, node_graph, n_graphs) / d
            rel = _seg_sum(
                (abs_diff[:, i] / (torch.abs(targets[:, i]) + 1e-8)) * sel,
                node_graph, n_graphs) / d * 100.0
            out[f"max_{comp}_val"] = (val * g).sum()
            out[f"max_{comp}_mae"] = (mae * g).sum()
            out[f"max_{comp}_rel"] = (rel * g).sum()

    def extras():
        mse_pg, _ = _seg_mean((targets ** 2 - predictions ** 2).mean(-1),
                              node_graph, n_graphs, valid)
        out["mse"] = (mse_pg * g).sum()
        row_max = torch.where(vmask, abs_diff, _neg_inf(abs_diff)).amax(-1)
        mx = segment.segment_max(
            torch.where(valid, row_max, _neg_inf(row_max)), node_graph,
            n_graphs)
        out["max_mae"] = (torch.where(torch.isfinite(mx), mx,
                                      torch.zeros_like(mx)) * g).sum()
        mean_pg, cnt = _seg_mean(abs_diff.mean(-1), node_graph, n_graphs,
                                 valid)
        sq_pg, _ = _seg_mean((abs_diff ** 2).mean(-1), node_graph, n_graphs,
                             valid)
        var = torch.clamp_min(sq_pg - mean_pg ** 2, 0.0)
        c = cnt * targets.shape[1]
        unbias = c / torch.clamp_min(c - 1.0, 1.0)
        out["std_mae"] = (torch.sqrt(var * unbias) * g).sum()
        out["p90_abs"] = (_seg_masked_quantile(
            abs_diff.mean(-1), node_graph, n_graphs, valid, 0.9) * g).sum()

    everywhere = vmask & torch.ones_like(targets, dtype=torch.bool)
    if prediction_type == "static_stress":
        max_components(["x", "y", "xy"])
        high = (torch.abs(targets) >= threshold) & vmask
        low = (torch.abs(targets) < threshold) & vmask
        add_region("_high", high)
        add_region("_low", low)
        add_region("", everywhere)
        extras()
        return out

    if prediction_type == "static_disp":
        target_mag = torch.linalg.norm(
            torch.where(vmask, targets, torch.zeros_like(targets)), dim=1)
        tm = torch.where(valid, target_mag, _neg_inf(target_mag))
        seg_max = segment.segment_max(tm, node_graph, n_graphs)
        at_max = ((tm == seg_max[graph]) & valid).to(targets.dtype)
        den = torch.clamp_min(_seg_sum(at_max, node_graph, n_graphs), 1.0)
        err_mag = torch.linalg.norm(abs_diff, dim=1)
        mx_val = _seg_sum(target_mag * at_max, node_graph, n_graphs) / den
        mx_mae = _seg_sum(err_mag * at_max, node_graph, n_graphs) / den
        out["max_disp_val"] = (mx_val * g).sum()
        out["max_disp_mae"] = (mx_mae * g).sum()
        out["max_disp_rel"] = (mx_mae / (mx_val + 1e-8) * 100.0 * g).sum()
        max_components(["x", "y"])
        ones = torch.ones_like(targets, dtype=torch.bool)
        add_region("_high", ((target_mag >= threshold) & valid)[:, None]
                   & ones)
        add_region("_low", ((target_mag < threshold) & valid)[:, None]
                   & ones)
        add_region("", everywhere)
        extras()
        return out

    raise NotImplementedError(
        f"Error metrics not implemented for prediction type: "
        f"{prediction_type}")
