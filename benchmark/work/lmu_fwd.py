"""B2's function, a fused decoder stage's forward (work/lmu_stage.py): its
three convolutions' FLOPs (2 MACs: the transposed conv 2 P Cin Cd, conv_a
2 P 9 (Cd + Cs) C1, conv_b 2 P 9 C1 Cout over the P output pixels), and
x, the skip and the weights read once and y written once, float32. One
call a fused stage, in a train step's forward and in a request."""

from work import lmu_stage as stage


def calls(model: dict, traffic: dict):
    out = []
    for b, hc, wc, cin, cs, cd, c1, cout in stage.stages(model, traffic["batch"]):
        p = b * 4 * hc * wc
        flops = 2 * p * (cin * cd + 9 * (cd + cs) * c1 + 9 * c1 * cout)
        nbytes = 4 * (b * hc * wc * cin + p * cs + stage.weights(cin, cs, cd, c1, cout) + p * cout)
        out.append((flops, nbytes))
    return out
