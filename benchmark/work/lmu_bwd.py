"""B3's function, a fused decoder stage's backward (work/lmu_stage.py): the
stage's gradients with no recompute of the forward, six convolutions'
FLOPs over the P output pixels (the input gradients of conv_b, 2 P 9 C1
Cout, of conv_a, 2 P 9 C1 (Cd + Cs), and of the transposed conv, 2 P Cd
Cin; the three weight gradients, the same again), and x, the skip, dy
and the weights read once, dx, the skip's gradient and the weight
gradients written once, float32. One call a fused stage a train step."""

from work import lmu_stage as stage


def calls(model: dict, traffic: dict):
    if traffic["kind"] != "train":
        return []
    out = []
    for b, hc, wc, cin, cs, cd, c1, cout in stage.stages(model, traffic["batch"]):
        p = b * 4 * hc * wc
        flops = 2 * 2 * p * (9 * c1 * cout + 9 * c1 * (cd + cs) + cd * cin)
        acts = b * hc * wc * cin + p * cs
        nbytes = 4 * (2 * acts + p * cout + 2 * stage.weights(cin, cs, cd, c1, cout))
        out.append((flops, nbytes))
    return out
