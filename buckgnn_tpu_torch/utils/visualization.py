"""Visual validation + invariance-check tooling.

Re-implements the reference's inspection utilities (SURVEY §2 #20):
feature-name lists (Utils/Transform_Check.py:10-59), the per-feature
Original/Transformed/Difference table
(GraphCreate.check_graph_transformation, GraphCreate.py:908-1141),
side-by-side graph rendering (Transform_Check.py:428-529 /
Utils/Visualization.py), and the virtual-edge connectivity analysis
(average shortest path + diameter before/after rewiring,
Utils/Virtual_Edge_Creation_Demo.py:237-319).

The port of buckgnn_tpu/utils/visualization.py, on the port's GraphData.
matplotlib/networkx are imported lazily; everything else is plain NumPy so
the module loads in headless pipelines.
"""

from __future__ import annotations

import numpy as np

from buckgnn_tpu_torch.graph.batch import GraphData

__all__ = ["get_feature_names", "get_edge_feature_names", "feature_table",
           "plot_graph", "plot_transform_check", "connectivity_stats",
           "virtual_edge_report"]


def get_feature_names(prediction_type: str = "buckling",
                      use_z_coord: bool = False,
                      use_rotations: bool = False,
                      use_gp_forces: bool = False,
                      use_mode_shapes_as_features: bool = False,
                      use_super_node: bool = False) -> list[str]:
    """Node-feature names in build_graph's column order
    (get_feature_names, Utils/Transform_Check.py:10-59)."""
    names = ["X coord", "Y coord"] + (["Z coord"] if use_z_coord else [])
    names += ["SPC", "Force X", "Force Y"]
    if use_z_coord:
        names += ["Force Z"]
    names += ["Boundary", "Stiff 0/180", "Stiff 45/225", "Stiff 90/270",
              "Stiff 135/315"]
    if prediction_type == "buckling":
        names += ["Disp X", "Disp Y"] + (["Disp Z"] if use_z_coord else [])
        if use_rotations:
            names += ["Rot X", "Rot Y"] + (["Rot Z"] if use_z_coord else [])
        names += ["Sigma X", "Sigma Y", "Tau XY"]
        if use_gp_forces:
            for q in range(1, 5):
                names += [f"GP Force Q{q} X", f"GP Force Q{q} Y"]
        if use_mode_shapes_as_features:
            names += ["Mode X", "Mode Y", "Mode Z"]
    if use_super_node:
        names.append("Super Node Flag")
    return names


def get_edge_feature_names(use_axial_stress: bool = False) -> list[str]:
    names = ["Stiffener Flag", "Length/1000", "Dir X", "Dir Y"]
    if use_axial_stress:
        names.append("Axial Stress")
    names.append("Virtual Flag")
    return names


def feature_table(original: GraphData, transformed: GraphData,
                  feature_names: list[str] | None = None,
                  max_rows: int = 10) -> str:
    """Per-feature Original/Transformed/Difference table
    (check_graph_transformation, GraphCreate.py:908-1141)."""
    n_feat = original.x.shape[1]
    names = feature_names or [f"feat_{i}" for i in range(n_feat)]
    lines = [f"{'Feature':<16}{'Orig mean':>12}{'Trans mean':>12}"
             f"{'Max |diff|':>12}"]
    for i in range(n_feat):
        a = original.x[:, i]
        b = transformed.x[:, i]
        lines.append(
            f"{names[i][:15]:<16}{float(a.mean()):>12.4f}"
            f"{float(b.mean()):>12.4f}"
            f"{float(np.abs(a - b).max()):>12.4f}"
        )
    lines.append("")
    lines.append(f"{'node':<6}" + "".join(f"{n[:10]:>11}" for n in names[:6]))
    for r in range(min(max_rows, original.x.shape[0])):
        lines.append(
            f"{r:<6}" + "".join(f"{float(v):>11.4f}"
                                for v in transformed.x[r, :6])
        )
    return "\n".join(lines)


def _draw(ax, g: GraphData, title: str, color_feature: int | None = None):
    xy = np.asarray(g.x[:, :2])
    s = np.asarray(g.senders)
    r = np.asarray(g.receivers)
    virtual = (
        np.asarray(g.edge_attr[:, -1]) > 0.5
        if g.edge_attr.shape[1] >= 5 else np.zeros(len(s), bool)
    )
    for mask, style in ((~virtual, dict(color="0.6", lw=0.5)),
                        (virtual, dict(color="tab:orange", lw=0.4,
                                       alpha=0.5, linestyle="--"))):
        for a, b in zip(s[mask], r[mask]):
            if a < b:  # undirected pairs are materialized both ways
                ax.plot(xy[[a, b], 0], xy[[a, b], 1], **style)
    if color_feature is not None:
        sc = ax.scatter(xy[:, 0], xy[:, 1], c=g.x[:, color_feature], s=12,
                        zorder=3, cmap="viridis")
    else:
        sc = ax.scatter(xy[:, 0], xy[:, 1], color="tab:blue", s=12, zorder=3)
    if g.supernode >= 0:
        ax.scatter(*xy[g.supernode], marker="*", s=150, color="red",
                   zorder=4)
    ax.set_title(title)
    ax.set_aspect("equal")
    return sc


def plot_graph(g: GraphData, out_path: str,
               color_feature: int | None = None,
               title: str = "graph") -> str:
    """Render one graph (Utils/Visualization.py)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 7))
    sc = _draw(ax, g, title, color_feature)
    if color_feature is not None:
        fig.colorbar(sc, ax=ax, shrink=0.8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_transform_check(original: GraphData, transformed: GraphData,
                         out_path: str,
                         color_feature: int | None = None) -> str:
    """Side-by-side original-vs-transformed rendering
    (Transform_Check.py:428-529)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(13, 6.5))
    _draw(axes[0], original, "original", color_feature)
    _draw(axes[1], transformed, "transformed (canonical frame)",
          color_feature)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def connectivity_stats(g: GraphData, exclude_virtual: bool = False) -> dict:
    """Average shortest path length + diameter of the (largest component
    of the) graph (Virtual_Edge_Creation_Demo.py:237-319)."""
    import networkx as nx

    s = np.asarray(g.senders)
    r = np.asarray(g.receivers)
    if exclude_virtual and g.edge_attr.shape[1] >= 5:
        keep = np.asarray(g.edge_attr[:, -1]) <= 0.5
        s, r = s[keep], r[keep]
    G = nx.Graph()
    G.add_nodes_from(range(g.n_node))
    G.add_edges_from(zip(s.tolist(), r.tolist()))
    comp = max(nx.connected_components(G), key=len)
    sub = G.subgraph(comp)
    return dict(
        n_nodes=g.n_node,
        n_edges=sub.number_of_edges(),
        avg_shortest_path=float(nx.average_shortest_path_length(sub)),
        diameter=int(nx.diameter(sub)),
    )


def virtual_edge_report(g: GraphData) -> dict:
    """Connectivity improvement from virtual edges: stats with and without
    them (the demo's before/after comparison)."""
    with_v = connectivity_stats(g, exclude_virtual=False)
    without_v = connectivity_stats(g, exclude_virtual=True)
    return dict(
        without_virtual=without_v,
        with_virtual=with_v,
        path_reduction=(
            without_v["avg_shortest_path"] - with_v["avg_shortest_path"]
        ),
        diameter_reduction=without_v["diameter"] - with_v["diameter"],
    )
