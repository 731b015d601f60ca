"""Port vs JAX: the fused LMU stage. The JAX side is the Pallas forward and
backward kernels in CPU interpret mode (as tests/test_lmu_pallas.py runs
them) and the jnp reference; the port side is the plain versions of
ops/lmu.py, which the wrappers of ops/lmu_cuda.py run on CPU tensors, and
FusedStage's gradients. The CUDA kernels themselves are held against the
plain versions on the card by chip_smoke.py.

Tolerances: forward atol/rtol 1e-5 as tests/test_lmu_pallas.py (f32 sums
in another order); gradients scaled by the reference's max abs, atol 3e-4
as the JAX suite's backward checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvpe_tpu.ops.lmu_pallas import (_flipT, fused_stage, fused_stage_bwd_pallas,
                                      fused_stage_reference)
from ccvpe_tpu_torch.ops import lmu_cuda
from ccvpe_tpu_torch.ops.lmu import fused_stage_bwd_plain, fused_stage_plain
from ccvpe_tpu_torch.ops.lmu_cuda import FusedStage, kernel_weights

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_ATOL = 3e-4


def _case(seed, b, hc, wc, cin, cd, cskip, c1, cout, bias_scale=0.3):
    """numpy inputs in JAX layouts: x NHWC, wd (2,2,in,out), convs HWIO."""
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=0.3):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    x = mk(b, hc, wc, cin)
    skip = mk(b, 2 * hc, 2 * wc, cskip) if cskip else None
    ws = (mk(2, 2, cin, cd), mk(cd, scale=bias_scale), mk(3, 3, cd + cskip, c1),
          mk(c1, scale=bias_scale), mk(3, 3, c1, cout), mk(cout, scale=bias_scale))
    return x, skip, ws


def _torch_weights(ws):
    """JAX layouts -> torch's: deconv (in,out,2,2), conv OIHW."""
    wd, bd, w1, b1, w2, b2 = (torch.from_numpy(np.ascontiguousarray(w)) for w in ws)
    return (wd.permute(2, 3, 0, 1), bd, w1.permute(3, 2, 0, 1), b1,
            w2.permute(3, 2, 0, 1), b2)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# (b, hc, wc, cin, cd, cskip, c1, cout, strip): tests/test_lmu_pallas.py's
# cases (skip and none, two strip heights) and its stage-6 head geometry
FWD_CASES = [(2, 8, 16, 7, 5, 3, 6, 2, 4), (2, 8, 16, 7, 5, 0, 6, 2, 4),
             (2, 8, 16, 7, 5, 3, 6, 2, 8), (2, 8, 16, 7, 5, 0, 6, 2, 2),
             (1, 8, 32, 41, 16, 0, 16, 1, 4)]
FWD_IDS = [f"skip{c[5]}_strip{c[8]}_cin{c[3]}" for c in FWD_CASES]


@pytest.mark.parametrize("case", FWD_CASES, ids=FWD_IDS)
def test_fused_stage_plain_matches_pallas(case):
    *shape, strip = case
    x, skip, ws = _case(0, *shape)
    jws = [jnp.asarray(w) for w in ws]
    pallas = np.asarray(fused_stage(_j(x), _j(skip), *jws, strip=strip, interpret=True))
    ref = np.asarray(fused_stage_reference(_j(x), _j(skip), *jws))
    out = fused_stage_plain(_t(x), _t(skip), *_torch_weights(ws)).numpy()
    assert out.shape == pallas.shape == ref.shape
    np.testing.assert_allclose(out, pallas, **FWD_TOL)
    np.testing.assert_allclose(out, ref, **FWD_TOL)


def _grads_close(got, want, names):
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=GRAD_ATOL, err_msg=name)


def _to_jax_layout(grads):
    """(dx, dskip, dwd, dbd, dw1, db1, dw2, db2) torch layouts -> JAX's."""
    dx, dskip, dwd, dbd, dw1, db1, dw2, db2 = (None if g is None else g.detach().numpy()
                                               for g in grads)
    return (dx, dskip, dwd.transpose(2, 3, 0, 1), dbd, dw1.transpose(2, 3, 1, 0), db1,
            dw2.transpose(2, 3, 1, 0), db2)


NAMES = ("dx", "dskip", "dwd", "dbd", "dw1", "db1", "dw2", "db2")


@pytest.mark.parametrize("cskip,strip", [(3, 4), (0, 4), (3, 8)])
def test_fused_stage_bwd_plain_matches_pallas(cskip, strip):
    x, skip, ws = _case(7, 2, 8, 16, 7, 5, cskip, 6, 2)
    dy = (np.random.default_rng(8).normal(size=(2, 16, 32, 2)) * 0.3).astype(np.float32)
    want = fused_stage_bwd_pallas(_j(x), _j(skip), jnp.asarray(dy),
                                  *[jnp.asarray(w) for w in ws], strip=strip, interpret=True)
    got = _to_jax_layout(fused_stage_bwd_plain(_t(x), _t(skip), torch.from_numpy(dy),
                                               *_torch_weights(ws)))
    if cskip:
        _grads_close(got, want, NAMES)
    else:
        assert got[1] is None and want[1] is None
        keep = [i for i in range(8) if i != 1]
        _grads_close([got[i] for i in keep], [want[i] for i in keep],
                     [NAMES[i] for i in keep])


@pytest.mark.parametrize("cskip", [3, 0])
def test_fused_stage_function_grads_match_autograd(cskip):
    """FusedStage.apply on CPU tensors (plain forward, plain backward from
    the saved inputs) against autograd of the plain chain; launches nothing."""
    x, skip, ws = _case(3, 2, 8, 8, 5, 4, cskip, 6, 2)
    before = (lmu_cuda.fused_stage.launches, lmu_cuda.fused_stage_bwd.launches)

    def leaves():
        ts = [_t(x).clone().requires_grad_()]
        ts.append(None if skip is None else _t(skip).clone().requires_grad_())
        ts += [w.clone().requires_grad_() for w in _torch_weights(ws)]
        return ts

    a, b = leaves(), leaves()
    (FusedStage.apply(*a) ** 2).sum().backward()
    (fused_stage_plain(*b) ** 2).sum().backward()
    for ta, tb, name in zip(a, b, NAMES):
        if ta is None:
            continue
        scale = float(tb.grad.abs().max().clamp_min(1e-6))
        np.testing.assert_allclose(ta.grad.numpy() / scale, tb.grad.numpy() / scale,
                                   atol=GRAD_ATOL, err_msg=name)
    assert (lmu_cuda.fused_stage.launches, lmu_cuda.fused_stage_bwd.launches) == before


def test_large_biases_border_is_zero_padding():
    """Biases of 5: at the image border the convs see zero padding, not
    deconv(0) + bias, or the outer two-pixel ring would differ."""
    x, skip, ws = _case(5, 1, 6, 10, 4, 3, 2, 5, 2, bias_scale=5.0)
    jws = [jnp.asarray(w) for w in ws]
    pallas = np.asarray(fused_stage(_j(x), _j(skip), *jws, strip=2, interpret=True))
    out = fused_stage_plain(_t(x), _t(skip), *_torch_weights(ws)).numpy()
    np.testing.assert_allclose(out, pallas, atol=5e-5, rtol=1e-5)
    dy = np.random.default_rng(6).normal(size=out.shape).astype(np.float32)
    want = fused_stage_bwd_pallas(_j(x), _j(skip), jnp.asarray(dy), *jws, strip=2,
                                  interpret=True)
    got = _to_jax_layout(fused_stage_bwd_plain(_t(x), _t(skip), torch.from_numpy(dy),
                                               *_torch_weights(ws)))
    _grads_close(got, want, NAMES)


def _tpu_operands_of_padded(ws):
    """kernel_weights' six operands for the JAX-layout weights `ws`, each
    checked to be zero beyond its true width and to have pad_co columns,
    then with the padding stripped, beside the Pallas kernels' operands
    (lmu_pallas.py :381-383, :593-597): wd [4,Cin,Cd], w1/w2 taps x in x out,
    and the _flipT operands of the backward."""
    wd, _, w1, _, w2, _ = ws
    cin, cd = wd.shape[2:]
    c, c1 = w1.shape[2:]
    cout = w2.shape[3]
    want = [wd.reshape(4, cin, cd), w1.reshape(9, c, c1), w2.reshape(9, c1, cout),
            np.asarray(_flipT(w2)).reshape(9, cout, c1), np.asarray(_flipT(w1)).reshape(9, c1, c),
            wd.reshape(4, cin, cd).transpose(0, 2, 1)]
    got = []
    for op, ref in zip(kernel_weights(*_torch_weights(ws)[0::2]), want):
        op = op.numpy()
        n = ref.shape[-1]
        assert op.shape == (*ref.shape[:-1], lmu_cuda.pad_co(n))
        assert op.flags.c_contiguous
        assert not op[..., n:].any(), "the padding must be exact zeros"
        got.append(op[..., :n])
    return got, want


def test_kernel_weight_layouts_match_the_tpu_kernels():
    """The wrapper's operands, padding stripped, equal the Pallas kernels'."""
    _, _, ws = _case(9, 1, 2, 2, 5, 4, 3, 6, 2)
    for got, want in zip(*_tpu_operands_of_padded(ws)):
        np.testing.assert_array_equal(got, want)


# every channel count of the operands ragged: pad_co's columns for each
PAD_WIDTHS = {1: 4, 2: 4, 3: 4, 16: 16, 41: 48, 81: 88}


@pytest.mark.parametrize("n", list(PAD_WIDTHS))
def test_kernel_weights_pad_to_pad_co_with_zeros(n):
    """Cin = Cd = C1 = Cout = n (C = n + 3 with a skip of 3): each operand
    holds torch's weights in its first columns, exact zeros up to pad_co
    (csrc/lmu.cu's), and the TPU kernel's operand once the padding goes."""
    assert lmu_cuda.pad_co(n) == PAD_WIDTHS[n]
    _, _, ws = _case(11, 1, 2, 2, n, n, 3, n, n)
    for got, want in zip(*_tpu_operands_of_padded(ws)):
        np.testing.assert_array_equal(got, want)


def test_phase_timer_names_every_phase_of_the_kernel():
    """BWD_PHASES names csrc/lmu.cu's BwdPhase entries, one each, in order."""
    import re
    from ccvpe_tpu_torch.csrc.build import CSRC
    src = (CSRC / "lmu.cu").read_text()
    body = re.search(r"enum BwdPhase \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1] == "kBwdPhases"
    assert len(names) - 1 == len(lmu_cuda.BWD_PHASES) == len(set(lmu_cuda.BWD_PHASES))


def test_phase_timer_needs_the_card():
    x, skip, ws = _case(3, 1, 4, 4, 5, 4, 2, 6, 2)
    dy = torch.zeros(1, 8, 8, 2)
    with pytest.raises(ValueError, match="card"):
        lmu_cuda.bwd_phase_cycles(_t(x), _t(skip), dy, *_torch_weights(ws))
    assert lmu_cuda.load_timed_library.cache_info().currsize == 0
