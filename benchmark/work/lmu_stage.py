"""The fused decoder stages of a configuration (ModelConfig.
lmu_fused_min_res): every upsampling stage whose output side reaches it,
the last with its head. A stage maps x [B, Hc, Wc, Cin] through a 2x2
stride-2 transposed conv to Cd channels, concatenates the aerial skip
[B, 2Hc, 2Wc, Cs], and runs conv3x3 (C1) -> ReLU -> conv3x3 (Cout)."""

from reference import cvm


def stages(model: dict, batch: int):
    """(B, Hc, Wc, Cin, Cs, Cd, C1, Cout) of each fused stage, loc then ori."""
    min_res = model.get("lmu_fused_min_res", 0)
    if not min_res:
        return []
    n, g, d, k = len(model["roll_shifts"]), model["sat_grid"], model["sat_desc_dim"], model["num_bins"]
    skips = cvm.skip_channels(model)
    out = []
    for branch, k_in, extra, head in (("loc", 1, 1, 1), ("ori", k, 0, 2)):
        dec, conv = model[f"{branch}_deconv_out"], model[f"{branch}_conv_out"]
        for s in range(n):
            h = g * 2 ** s
            if 2 * h < min_res:
                continue
            cin = k_in + d if s == 0 else conv[s - 1] + extra
            last = s == n - 1
            c1, cout = (model["head_hidden"], head) if last else (conv[s], conv[s])
            out.append((batch, h, h, cin, 0 if last else skips.get(2 * h, 0), dec[s], c1, cout))
    return out


def weights(cin, cs, cd, c1, cout):
    return 4 * cin * cd + cd + 9 * (cd + cs) * c1 + c1 + 9 * c1 * cout + cout
