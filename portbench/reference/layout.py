"""The reference's own batch of its graphs, and the check of the program's
packed batch against it.

The reference computes over its graphs as they are: nodes panel by panel
in mesh order, the edge list as built. Only the dropout mask depends on
where the program put a node or an edge (the keyed hash takes the packed
row, and for the edge-window models the window slot), and that placement
is the program's free choice. So the reference reads the placement from
the packed batch, and first checks that the batch holds exactly its
graphs there: every panel's nodes (each matched to the program row with
the nearest features, which must lie within `FEATURE_TOL` and be one row
each), its target, its edge list as a set of row pairs, and for the
edge-window models each edge in one window slot with its features. A
batch that fails raises `LayoutError`, and the run is not correct.
"""

from __future__ import annotations

import numpy as np
import torch

# Both sides compute the features from the same float64 arithmetic and
# round them once to float32 (equal bits on every panel tried); a wrong
# column, scale or node moves a feature by far more.
FEATURE_TOL = 1e-5


class LayoutError(ValueError):
    pass


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise LayoutError(f"packed batch: {what}")


def _pair_keys(s, r, n_rows: int) -> np.ndarray:
    return np.asarray(s, np.int64) * n_rows + np.asarray(r, np.int64)


def build(graphs: list[dict], lay: dict, stats, cfg: dict, device) -> dict:
    """The reference's batch ``d`` for the forward functions, with ``rows``
    (the packed row of each node) and, for the edge-window models,
    ``slots`` and ``n_slots``."""
    n_rows = lay["nodes"].shape[0]
    node_graph = lay["node_graph"]
    real = lay["node_mask"]
    _check(int(lay["graph_mask"].sum()) == len(graphs),
           f"{int(lay['graph_mask'].sum())} panels, not {len(graphs)}")
    rows, off = [], 0
    offsets = []
    for g, gr in enumerate(graphs):
        prow = np.nonzero(real & (node_graph == g))[0]
        x = gr["x"]
        _check(len(prow) == len(x), f"panel {g} has {len(prow)} rows, not "
               f"{len(x)}")
        dist = torch.cdist(torch.from_numpy(x).double(),
                           torch.from_numpy(lay["nodes"][prow]).double())
        best = dist.argmin(1).numpy()
        _check(len(np.unique(best)) == len(x),
               f"panel {g}'s nodes do not match its rows one to one")
        gap = float(np.abs(lay["nodes"][prow[best]] - x).max())
        _check(gap <= FEATURE_TOL, f"panel {g}'s features differ by {gap}")
        ygap = abs(float(lay["y"][g].reshape(-1)[0]) - float(gr["y"][0]))
        _check(ygap <= FEATURE_TOL, f"panel {g}'s target differs by {ygap}")
        rows.append(prow[best])
        offsets.append(off)
        off += len(x)
    rows = np.concatenate(rows)
    send = np.concatenate([gr["senders"] + o
                           for gr, o in zip(graphs, offsets)])
    recv = np.concatenate([gr["receivers"] + o
                           for gr, o in zip(graphs, offsets)])
    ours = np.sort(_pair_keys(rows[send], rows[recv], n_rows))
    m = lay["edge_mask"]
    theirs = np.sort(_pair_keys(lay["senders"][m], lay["receivers"][m],
                                n_rows))
    _check(ours.shape == theirs.shape and bool((ours == theirs).all()),
           "its edge list is not the graphs' edges")
    d = dict(x=np.concatenate([gr["x"] for gr in graphs]),
             edge_attr=np.concatenate([gr["edge_attr"] for gr in graphs]),
             send=send, recv=recv, rows=rows,
             graph=np.concatenate([np.full(len(gr["x"]), g)
                                   for g, gr in enumerate(graphs)]),
             y=np.concatenate([gr["y"] for gr in graphs]))
    if "slot_send" in lay:
        ss, sr = lay["slot_send"], lay["slot_recv"]
        used = (ss >= 0) & (sr >= 0)
        keys = _pair_keys(ss[used], sr[used], n_rows)
        order = np.argsort(keys, kind="stable")
        skeys, sslot = keys[order], np.nonzero(used)[0][order]
        want = _pair_keys(rows[send], rows[recv], n_rows)
        at = np.searchsorted(skeys, want)
        _check(len(keys) == len(want) and len(np.unique(keys)) == len(keys)
               and bool((skeys[np.minimum(at, len(skeys) - 1)] == want)
                        .all()), "its windows do not hold each edge once")
        slots = sslot[at]
        fe = d["edge_attr"].shape[1]
        egap = float(np.abs(lay["slot_edges"][slots, :fe]
                            - d["edge_attr"]).max())
        _check(egap <= FEATURE_TOL, f"window edge features differ by {egap}")
        d.update(slots=slots, n_slots=int(lay["n_slots"]))
    out = {k: torch.as_tensor(v, device=device) for k, v in d.items()
           if k != "n_slots"}
    for k in ("send", "recv", "rows", "graph", "slots"):
        if k in out:
            out[k] = out[k].long()
    out.update(n_graphs=len(graphs), hidden=cfg["hidden_channels"],
               layers=cfg["num_layers"], stats=stats,
               n_slots=d.get("n_slots", 0))
    return out
