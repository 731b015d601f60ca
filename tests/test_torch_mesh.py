"""core/mesh.py, the port of ccvpe_tpu/core/mesh.py: the launch flags and
their environment defaults equal the JAX package's; at one process every
collective is a no-op; over 2 gloo ranks (tests/_torch_dist.py)
all_hosts_concat pools unequal lengths in rank order as float64,
all_hosts_gather stacks, gather_rows concatenates, global_max reduces,
and global_sum's backward all-reduces the cotangent, so each rank's
gradient of its own input is N times that of the global sum, whose
parameter gradients mean_grads averages (core/mesh.py's note); a train-mode
BatchNorm over 2 ranks' blocks gives the one-process BatchNorm of the
whole batch: outputs, input and parameter gradients, running stats (float32
sums in another order: atol 1e-5 on unit-scale values, rtol 1e-5); a model
axis that does not divide the processes raises, and a (1, 2) mesh gives
each rank its model index, a halo from the true neighbour rows and a
gather of unequal blocks, with their backward; the graphed train step
refuses a gloo group (its collectives cannot be captured)."""

import argparse

import numpy as np
import pytest
import torch

from _torch_dist import spawn
from ccvpe_tpu.core import mesh as jmesh
from ccvpe_tpu_torch.core import mesh

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("env", [{}, {"CCVPE_COORDINATOR": "10.0.0.1:1234",
                                      "CCVPE_NUM_PROCESSES": "4", "CCVPE_PROCESS_ID": "3"}],
                         ids=["defaults", "environment"])
@pytest.mark.parametrize("argv", [[], ["--coordinator", "h:1", "--num_processes", "2",
                                       "--process_id", "1"]], ids=["no_flags", "flags"])
def test_flags_equal_jax(env, argv, monkeypatch):
    for k in ("CCVPE_COORDINATOR", "CCVPE_NUM_PROCESSES", "CCVPE_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    parsed = []
    for add in (jmesh.add_distributed_flags, mesh.add_distributed_flags):
        p = argparse.ArgumentParser()
        add(p)
        parsed.append(vars(p.parse_args(argv)))
    assert parsed[0] == parsed[1]


def test_one_process_is_a_no_op():
    assert not mesh.initialized()
    assert (mesh.rank(), mesh.world_size(), mesh.is_main()) == (0, 1, True)
    args = argparse.Namespace(coordinator=None, num_processes=1, process_id=0)
    assert mesh.setup_distributed(args) == (0, 1)
    assert not mesh.initialized()
    assert mesh.make_mesh() == mesh.Mesh(1, 1, ("data", "model"))
    x = [3.0, 1.0]
    assert mesh.all_hosts_concat(x).tolist() == x
    assert mesh.all_hosts_gather(np.arange(3)).tolist() == [0, 1, 2]
    t = torch.arange(4.0, requires_grad=True)
    assert mesh.global_sum(t) is t and mesh.gather_rows(t) is t
    assert torch.equal(mesh.global_max(t), t)
    t.grad = torch.ones(4)
    mesh.mean_grads([t])
    assert torch.equal(t.grad, torch.ones(4))
    assert mesh.capturable()
    with pytest.raises(ValueError, match="does not divide the 1 processes"):
        mesh.make_mesh(model=2)
    with pytest.raises(ValueError, match="2 processes"):
        mesh.make_mesh(data=2)
    assert mesh.current_mesh() == mesh.Mesh(1, 1)
    assert (mesh.data_size(), mesh.model_size(), mesh.data_index(), mesh.model_index()) == (
        1, 1, 0, 0)
    assert mesh.to_model(t) is t and mesh.gather_model(t, 0, [4]) is t


def test_process_device():
    assert mesh.process_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mesh.process_device()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(4, 6, 5, 3)) * 2 + 0.5).astype(np.float32)
    w = rng.normal(size=(4, 6, 5, 3)).astype(np.float32)
    return x, w, spawn("mesh_checks", 2, tmp_path_factory.mktemp("mesh"), x, w)


def test_two_rank_collectives(ranks):
    _, _, got = ranks
    for r, out in enumerate(got):
        assert (out["rank"], out["world"], out["backend"]) == (r, 2, "gloo")
        assert not out["capturable"]
        assert out["mesh"] == mesh.Mesh(2, 1, ("data", "model"))
        assert out["concat"].dtype == np.float64
        assert out["concat"].tolist() == [0.5, 1.5, 2.5, 10.25]
        assert out["gather"].tolist() == [[0, 0], [1, 2]]
        assert out["rows"].tolist() == [0, 1, 2, 10, 11, 12]
        assert out["max"].tolist() == [1.0, 0.0]
        assert "does not divide the 2 processes" in out["model_axis_error"]
        # (data 1, model 2): each rank its model index; rank 0 holds rows
        # 0-2 of the 5-row map, rank 1 rows 3-4; the halo's rows come from
        # the true neighbours, and its backward adds the cotangent 10 of a
        # neighbour's halo row into this rank's edge row
        assert out["model_mesh"] == (1, 2, 0, r)
        mc = out["model_collectives"]
        whole = torch.arange(10.0).reshape(1, 1, 5, 2)
        assert torch.equal(mc["whole"], whole)
        padded = torch.nn.functional.pad(whole, (0, 0, 1, 1))
        assert torch.equal(mc["halo"], padded[:, :, (0, 3)[r]:(5, 7)[r]])
        edge = torch.tensor([[11.0], [11.0], [21.0]] if r == 0 else [[21.0], [11.0]])
        assert torch.equal(mc["grad"][0, 0], edge.expand(-1, 2))
        assert "gloo" in out["graph_refusal"] and "cuda_graph=False" in out["graph_refusal"]
        # global sum 1 + 4 + 4 + 16; its gradient 2 x, N times on each rank
        assert float(out["sum"]) == 25.0
        assert torch.equal(out["sum_grad"], 2 * torch.tensor([2.0, 4.0]) * (r + 1))


def test_two_rank_batch_norm_is_the_global_batch(ranks):
    from ccvpe_tpu_torch.nn.efficientnet import batch_norm
    x, w, got = ranks
    torch.manual_seed(0)
    bn = batch_norm(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    loss = (y * torch.from_numpy(w)).sum()
    loss.backward()
    for r, out in enumerate(got):
        b = out["bn"]
        rows = slice(2 * r, 2 * r + 2)
        torch.testing.assert_close(b["y"], y.detach()[rows], **TOL)
        torch.testing.assert_close(b["x_grad"] / 2, xt.grad[rows], **TOL)
        torch.testing.assert_close(b["loss"], loss.detach(), **TOL)
        for k, p in bn.named_parameters():
            torch.testing.assert_close(b["grads"][k], p.grad, **TOL)
        for k, v in bn.named_buffers():
            torch.testing.assert_close(b["buffers"][k], v, **TOL)
    assert all(torch.equal(got[0]["bn"]["buffers"][k], got[1]["bn"]["buffers"][k])
               for k in got[0]["bn"]["buffers"])
