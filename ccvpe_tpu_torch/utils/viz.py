"""Qualitative result rendering (the port of ccvpe_tpu/utils/viz.py;
reference visualize_qualitative_results_VIGOR.py:120-153): heatmap overlay
on the aerial patch (log scale), GT/pred markers, quiver field of the
predicted orientation vectors every `quiver_step` pixels.

Pure numpy with a lazy matplotlib import, so the module imports where
matplotlib is missing (the card's machine has none) and no path of the
smoke run reaches it; `ccvpe_tpu_torch/scripts/visualize_vigor.py` wires in
data and model.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def render_qualitative(
    grd_img: np.ndarray,        # [Hg, Wg, 3] in [0, 1]
    sat_img: np.ndarray,        # [Hs, Ws, 3] in [0, 1]
    heatmap: np.ndarray,        # [Hs, Ws]
    ori: np.ndarray,            # [Hs, Ws, 2] (cos, sin)
    gt_rc: Tuple[float, float],
    pred_rc: Tuple[float, float],
    out_path: str,
    angle_deg: Optional[float] = None,
    quiver_step: int = 40,
) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LogNorm

    hs, ws = heatmap.shape
    fig, axes = plt.subplots(1, 2, figsize=(14, 6))
    title = "ground"
    if angle_deg is not None:
        title += f" (angle {angle_deg:.1f} deg)"
    axes[0].imshow(grd_img)
    axes[0].set_title(title)
    axes[0].axis("off")

    axes[1].imshow(sat_img)
    axes[1].imshow(heatmap, norm=LogNorm(vmin=max(float(heatmap.min()), 1e-10),
                                         vmax=float(heatmap.max())),
                   alpha=0.6, cmap="Reds")
    # quiver of the predicted orientation field every quiver_step px
    # (visualize_qualitative_results_VIGOR.py:140-147)
    ys, xs = np.mgrid[quiver_step // 2:hs:quiver_step,
                      quiver_step // 2:ws:quiver_step]
    cos_v = ori[ys, xs, 0]
    sin_v = ori[ys, xs, 1]
    # angle 0 = North (up), counter-clockwise positive
    axes[1].quiver(xs, ys, -sin_v, cos_v, color="gold", width=0.003)
    axes[1].scatter([gt_rc[1]], [gt_rc[0]], marker="*", s=200, c="lime",
                    label="GT")
    axes[1].scatter([pred_rc[1]], [pred_rc[0]], marker="x", s=150, c="cyan",
                    label="pred")
    axes[1].legend()
    axes[1].set_title("heatmap + orientation field")
    axes[1].axis("off")

    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
