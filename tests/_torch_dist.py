"""Process groups for the port's scale-out tests (tests/test_torch_mesh.py,
test_torch_distributed*.py): `spawn` runs a function of this module in N
fresh processes joined by gloo through a file store under pytest's
tmp_path (no TCP port to collide across the suite's workers), each join
under its own timeout, and hands back each rank's result; `start` and
`finish` split it, so that the caller computes its one-process reference
while the ranks run. Worker functions import torch and the port only,
never JAX."""

import hashlib
import multiprocessing
import os
import traceback
from typing import List, Tuple

import numpy as np
import torch

# a join's limit: the suite's parallel workers share the host's cores, and
# a hang must fail well inside the suite's own limit
JOIN_TIMEOUT_S = 240
# one intra-op thread a rank: the suite's workers already fill the cores
WORKER_THREADS = 1


def _entry(fn_name, rank, world, store, out, args, join=True):
    try:
        torch.set_num_threads(WORKER_THREADS)
        from ccvpe_tpu_torch.core import mesh
        if join:
            mesh.init_distributed(f"file://{store}", world, rank, device="cpu")
        else:       # the function joins itself, from (rank, world, store)
            args = (rank, world, store, *args)
        try:
            result = globals()[fn_name](*args)
        finally:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
        torch.save({"result": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise


def start(fn_name: str, world: int, tmp_path, *args, join: bool = True) -> Tuple:
    """fn_name(*args) of this module started on `world` ranks, joined into
    a gloo group first; with join=False called as fn_name(rank, world,
    store path, *args) with no group."""
    ctx = multiprocessing.get_context("spawn")
    tmp = os.path.join(str(tmp_path), f"spawn_{fn_name}_{os.getpid()}_{id(args)}")
    os.makedirs(tmp)
    store = os.path.join(tmp, "store")
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_entry, args=(fn_name, r, world, store, outs[r], args, join))
             for r in range(world)]
    for p in procs:
        p.start()
    return fn_name, procs, outs


def finish(started: Tuple, timeout: float = JOIN_TIMEOUT_S) -> List:
    """Each rank's result of a `start`, every join under `timeout`."""
    fn_name, procs, outs = started
    try:
        for p in procs:
            p.join(timeout)
            assert not p.is_alive(), f"{fn_name}: a rank ran over {timeout} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        got = torch.load(out, weights_only=False) if os.path.exists(out) else {}
        assert p.exitcode == 0 and "result" in got, (
            f"{fn_name} rank {r} exited {p.exitcode}:\n{got.get('error', '')}")
        results.append(got["result"])
    return results


def spawn(fn_name: str, world: int, tmp_path, *args, timeout: float = JOIN_TIMEOUT_S) -> List:
    """fn_name(*args) of this module on `world` ranks; each rank's result."""
    return finish(start(fn_name, world, tmp_path, *args), timeout)


# --- worker functions (run in every rank; also callable in one process) ---

def block(batch):
    """This rank's contiguous block of a global batch (a tuple of arrays)."""
    from ccvpe_tpu_torch.core import mesh
    n, r = mesh.world_size(), mesh.rank()
    b = len(batch[0]) // n
    return tuple(np.asarray(v)[r * b:(r + 1) * b] for v in batch)


def digest(tensors) -> dict:
    """name -> sha256 of the tensor's bytes: a rank's state, compared with
    another rank's without sending it back."""
    return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, v in tensors.items()}


def train_steps(cfg, train_cfg, state_dict, batches, seeds, drop_connect=True):
    """len(batches) steps of make_train_step on the CPU from `state_dict`,
    each on this rank's block of the global batch, the generator seeded by
    seeds[i]. Every rank returns its per-step metrics and a digest of its
    model state, last gradients and Adam state; rank 0 also the model
    state and the last gradients."""
    from unittest import mock

    import ccvpe_tpu_torch.nn.efficientnet as teff
    from ccvpe_tpu_torch.core import mesh
    from ccvpe_tpu_torch.train import step as tstep
    rate = teff.DROP_CONNECT_RATE if drop_connect else 0.0
    with mock.patch.object(teff, "DROP_CONNECT_RATE", rate):
        state = tstep.create_train_state(cfg, train_cfg, device="cpu", state_dict=state_dict)
    step = tstep.make_train_step(cfg, train_cfg)
    gen = torch.Generator()
    metrics = []
    for batch, seed in zip(batches, seeds):
        gen.manual_seed(seed)
        state, m = step(state, block(batch), gen)
        metrics.append({k: float(v) for k, v in m.items()})
    model_state = state.model.state_dict()
    grads = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}
    adam = {f"{i}.{k}": v for i, st in state.optimizer.opt.state_dict()["state"].items()
            for k, v in st.items() if torch.is_tensor(v)}
    everything = {**model_state, **{f"grad.{k}": v for k, v in grads.items()},
                  **{f"adam.{k}": v for k, v in adam.items()}}
    out = dict(metrics=metrics, digest=digest(everything))
    if mesh.rank() == 0:
        out.update(state={k: v.clone() for k, v in model_state.items()},
                   grads={k: v.clone() for k, v in grads.items()})
    return out


def train_cases(cases, state_dict, batches):
    """train_steps for each (ModelConfig, TrainConfig, seeds, drop_connect)
    of `cases`, in one process group."""
    return [train_steps(cfg, tc, state_dict, batches, seeds, drop)
            for cfg, tc, seeds, drop in cases]


def mesh_checks(x_global, w_global):
    """The collectives of core/mesh.py on this rank, and a train-mode
    BatchNorm over this rank's block of x_global [N*B, C, H, W] (loss:
    the global sum of y * w_global's block, its backward and the gradient
    mean, as the train step runs them)."""
    from ccvpe_tpu_torch.core import mesh
    from ccvpe_tpu_torch.nn.efficientnet import batch_norm
    r, n = mesh.rank(), mesh.world_size()
    out = dict(rank=r, world=n, backend=mesh.backend(), capturable=mesh.capturable(),
               mesh=mesh.make_mesh())
    out["concat"] = mesh.all_hosts_concat([0.5, 1.5, 2.5] if r == 0 else [10.25] * r)
    out["gather"] = mesh.all_hosts_gather(np.array([r, 2 * r]))
    out["rows"] = mesh.gather_rows(torch.arange(3) + 10 * r)
    out["max"] = mesh.global_max(torch.tensor([float(r), -float(r)]))
    x = (torch.tensor([1.0, 2.0]) * (r + 1)).requires_grad_()
    total = mesh.global_sum(x.square().sum())
    total.backward()
    out["sum"], out["sum_grad"] = total.detach(), x.grad
    try:
        mesh.make_mesh(model=2)
    except NotImplementedError as e:
        out["model_axis_error"] = str(e)
    from ccvpe_tpu_torch.core import config as tcfg
    from ccvpe_tpu_torch.train.step import make_train_step
    try:   # the graphed path, which a step on the card takes, under gloo
        make_train_step(tcfg.tiny(), tcfg.TrainConfig())._graphed(None, None, None)
    except RuntimeError as e:
        out["graph_refusal"] = str(e)
    torch.manual_seed(0)
    bn = batch_norm(x_global.shape[1]).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
    (xb, wb) = block((x_global, w_global))
    xb = torch.from_numpy(xb).requires_grad_()
    y = bn(xb)
    loss = mesh.global_sum((y * torch.from_numpy(wb)).sum())
    loss.backward()
    mesh.mean_grads(list(bn.parameters()))
    out["bn"] = dict(y=y.detach(), x_grad=xb.grad, loss=loss.detach(),
                     grads={k: p.grad for k, p in bn.named_parameters()},
                     buffers={k: v.clone() for k, v in bn.named_buffers()})
    return out


def _driver_data(n_train, n_val):
    from _torch_driver import SyntheticDataset
    from ccvpe_tpu_torch.core import config as tcfg
    cfg = tcfg.tiny()
    return cfg, SyntheticDataset(cfg, n=n_train), SyntheticDataset(cfg, n=n_val, seed=100)


def sharded_loaders(dataset, global_batch, shuffle):
    """epoch -> this rank's shard of the scripts' loader at `global_batch`
    (shuffled by the epoch, or in order with the ragged tail)."""
    from ccvpe_tpu_torch.core import mesh
    from ccvpe_tpu_torch.data.loader import ThreadedLoader
    n = mesh.world_size()
    return lambda epoch: ThreadedLoader(dataset, global_batch // n, shuffle=shuffle, seed=epoch,
                                        num_workers=2, drop_last=shuffle,
                                        shard_id=mesh.rank(), num_shards=n)


def trainer_state_digest(trainer) -> dict:
    st = trainer.state
    adam = {f"adam.{i}.{k}": v for i, s in st.optimizer.opt.state_dict()["state"].items()
            for k, v in s.items() if torch.is_tensor(v)}
    return digest({**st.model.state_dict(), **adam})


def trainer_runs(base, n_train, n_val, global_batch, fail_at, train_over):
    """On every rank: a control Trainer.fit under `base`/control, a fit
    stopped by fake_fail_at_step=fail_at (a checkpoint every step) under
    `base`/resumed, and a new Trainer resumed there to the end. Each
    Trainer's state digest, the resumed one's restore point, and whether
    this rank wrote metric rows."""
    import dataclasses

    from ccvpe_tpu_torch.core import config as tcfg
    from ccvpe_tpu_torch.train.trainer import Trainer
    cfg, train_set, val_set = _driver_data(n_train, n_val)
    tc = tcfg.TrainConfig(**{**dict(batch_size=global_batch, epochs=1, log_every=1,
                                    keep_checkpoints=2), **train_over})
    train = sharded_loaders(train_set, global_batch, True)
    val = sharded_loaders(val_set, global_batch, False)
    mpp = lambda city: 0.1     # noqa: E731
    control = Trainer(cfg, tc, workdir=f"{base}/control", device="cpu")
    control.fit(train, val, mpp)
    faulted = Trainer(cfg, dataclasses.replace(tc, checkpoint_every_steps=1,
                                               fake_fail_at_step=fail_at),
                      workdir=f"{base}/resumed", device="cpu")
    try:
        faulted.fit(train, val, mpp)
        failed = None
    except RuntimeError as e:
        failed = str(e)
    resumed = Trainer(cfg, tc, workdir=f"{base}/resumed", device="cpu")
    restored = (resumed.restored, resumed.state.step, dict(resumed.cursor))
    resumed.fit(train, val, mpp)
    return dict(control=trainer_state_digest(control), resumed=trainer_state_digest(resumed),
                failed=failed, restored=restored, writes_rows=control.metrics is not None,
                step=control.state.step)


def eval_runs(n, batch, seed):
    """eval_over_loader and stream_eval on this rank's shard of a synthetic
    split of n samples, tiny() weights from `seed`: each summary and the
    pooled per-sample arrays each pooled (mesh.all_hosts_concat's outputs,
    recorded)."""
    from unittest import mock

    from _torch_driver import SyntheticDataset
    from ccvpe_tpu_torch.core import config as tcfg
    from ccvpe_tpu_torch.core import mesh
    from ccvpe_tpu_torch.data.loader import ThreadedLoader
    from ccvpe_tpu_torch.models.cvm import build_cvm
    from ccvpe_tpu_torch.train.evaluate import eval_over_loader
    from ccvpe_tpu_torch.train.step import make_eval_decode_step
    from ccvpe_tpu_torch.train.stream import stream_eval
    cfg = tcfg.tiny()
    model = build_cvm(cfg, "cpu", generator=torch.Generator().manual_seed(seed))
    data = SyntheticDataset(cfg, n=n, seed=50)
    pooled, concat = [], mesh.all_hosts_concat

    def record(x):
        out = concat(x)
        pooled.append(np.asarray(out, np.float64))
        return out

    r, k = mesh.rank(), mesh.world_size()
    with mock.patch.object(mesh, "all_hosts_concat", record):
        loader = ThreadedLoader(data, batch, shuffle=False, num_workers=2, drop_last=False,
                                shard_id=r, num_shards=k)
        summary = eval_over_loader(make_eval_decode_step(model), loader, lambda c: 0.1,
                                   with_prob_at_gt=True, device="cpu")
        eval_pooled = list(pooled)
        pooled.clear()
        stream = stream_eval(model, cfg, data, range(n), batch_size=batch, num_workers=2,
                             shard_id=r, num_shards=k, device="cpu")
    return dict(summary=summary, pooled=eval_pooled, stream=stream, stream_pooled=list(pooled))


def oxford_script(rank, world, store, root, sat_path, workdir, common, checkpoint=None):
    """scripts/train_oxford.py over `world` processes with its distributed
    flags (a file:// coordinator; none for one process): training under
    `workdir`, or with `checkpoint` the streaming evaluation of that
    checkpoint directory; the aerial output cut to 128 as
    test_torch_scripts.py cuts it. Returns the step reached, or the three
    traversals' summaries."""
    from ccvpe_tpu_torch.data import oxford
    from ccvpe_tpu_torch.scripts import train_oxford
    oxford.OUT = 128
    argv = ["--grd_root", root, "--sat_path", sat_path, "--device", "cpu", "--workdir", workdir]
    if checkpoint:
        argv += ["--training", "False", "--checkpoint", checkpoint]
    if world > 1:
        argv += ["--coordinator", f"file://{store}", "--num_processes", str(world),
                 "--process_id", str(rank)]
    result = train_oxford.main(argv + common)
    return result if checkpoint else result.state.step
