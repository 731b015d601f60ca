"""B1's function, the orientation-rolled correlation, at each of a step's
scales: scores[b, t, k] = <window_k(S[b, t]), g[b]> / (|window_k| |g|) for
the aerial map S [B, N, D] at N positions and the ground descriptor g
[B, L], K bins. Its work, whatever route computes it: the products num
(2 B N K D) and den^2 (2 B N K D) and the square of S (B N D) in FLOPs;
S and g read once and the scores written once, float32, in bytes. One
call a scale, the same in the forward of a train step and of a request."""

from reference import cvm


def scales(model: dict, batch: int):
    """(B, N, D, L, K) of each scale the forward correlates."""
    g, k = model["sat_grid"], model["num_bins"]
    dims = [model["sat_desc_dim"]] + list(model["loc_conv_out"])
    w = cvm.b0_sizes(tuple(model["grd_size"]))[-1][1]
    return [(batch, (g * 2 ** s) ** 2, dims[s], w * c, k)
            for s, c in enumerate(model["grd_desc_channels"])]


def calls(model: dict, traffic: dict):
    """(FLOPs, bytes) of each call in one step (a train step or a request)."""
    return [(4 * b * n * k * d + b * n * d, 4 * (b * n * d + b * length + b * n * k))
            for b, n, d, length, k in scales(model, traffic["batch"])]
