"""The port's data parallelism (gtcrn_micro_tpu_torch.parallel,
train.trainer's ``group``, train.train's ``distributed``, serve's ``mesh``)
on the CPU: gloo process groups and meshes of CPU devices.

Tolerances and why:

- two gloo ranks against one process, one f32 step on the JAX multi-process
  script's batch (scripts/multiproc_dp.py: 4 x 4,096 samples, seed 7,
  warmup 5): the loss at rtol 1e-5 and every param at atol 2e-5, the bounds
  of that script (its docstring and line 175), and every averaged gradient
  within 1e-4 of the largest gradient, chip_smoke.py's bound on the card's
  gradients.  The two sides differ only in float32 summation order (a mean
  of two half-batch means; measured: loss 7.7e-8 relative, params 1.2e-7,
  gradients 9.4e-7 of the largest; 3.6e-5 with four ranks of one row).
  The one process and the ranks are also held to the jitted JAX train step
  on the same batch and params at the same loss and param bounds;
- the torchrun run against one process after two steps (the second update
  has a learning rate above 0): the loss at rtol 1e-5, every param at atol
  2e-5 except the conv and pointwise biases ahead of a training-mode
  BatchNorm, held to twice the second step's learning rate
  (tests/test_torch_train.py: their true gradient is 0, so each side's
  rounding noise picks the sign of a full Adam step);
- one rank in a group against no group: bit-identical, since an all-reduce
  over one rank is the identity and each rank's mean is the one-process
  mean;
- sharded serving against the unsharded server: atol 2e-6 in spec mode and
  2e-5 in audio mode, the bounds of tests/test_serve.py:262,274.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gtcrn_micro_tpu_torch import serve
from gtcrn_micro_tpu_torch.models.gtcrn_micro import GTCRNMicro, flatten, init_params
from gtcrn_micro_tpu_torch.ops.fused_step import LayoutGTCRNMicro
from gtcrn_micro_tpu_torch.parallel import mesh, multiproc
from gtcrn_micro_tpu_torch.serve import CohortServer
from gtcrn_micro_tpu_torch.train.scheduler import WarmupCosineConfig, warmup_cosine_lr
from gtcrn_micro_tpu_torch.train.trainer import make_optimizer, make_train_step
from gtcrn_micro_tpu_torch.utils.checkpoint import CheckpointManager
from gtcrn_micro_tpu_torch.utils.make_smoke_data import make_smoke_data

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this module (the suite runs several workers
    on the host's cores), the caller's count restored."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def single():
    """The one-process step of multiproc.train_step."""
    return multiproc.train_step(torch.device("cpu"))


@pytest.fixture
def world_of_one():
    """A one-rank gloo group in this process, torn down after the test."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{multiproc.free_port()}",
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


# -- training ------------------------------------------------------------------


def _jax_step(start: dict, noisy, clean):
    """One jitted step of the JAX trainer (multiproc's schedule) from the
    port's ``start`` params: (loss, flat numpy params)."""
    import jax

    from gtcrn_micro_tpu.models import GTCRNMicro as JModel
    from gtcrn_micro_tpu.train import trainer as jt
    from gtcrn_micro_tpu.train.scheduler import WarmupCosineConfig as JSched

    params = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), start)
    opt = jt.make_optimizer(params, JSched(warmup_steps=5, decay_until_step=100, max_lr=1e-3))
    params, _, loss = jax.jit(jt.make_train_step(JModel(), opt))(
        params, opt.init(params), noisy, clean)
    return float(loss), flatten(jax.tree.map(np.asarray, params))


def test_two_gloo_ranks_equal_one_process(single):
    ranks = multiproc.run_ranks(2, "cpu")
    errs = multiproc.compare(ranks, single)
    assert errs["loss"] <= 1 and errs["params"] <= 1 and errs["grads"] <= 1, errs
    assert errs["ranks"] == 0, errs  # both ranks hold the same model
    # the running statistics moved (the first update's lr is 0): the
    # comparison above holds them to the global batch's statistics
    start = init_params(torch.Generator().manual_seed(0), device="cpu")
    model = GTCRNMicro.from_params(start, device="cpu")
    before = model.state_dict()
    moved = [k for k in before if not torch.equal(before[k], single["params"][k])]
    assert moved and all("running" in k for k in moved)
    # and the one process and the ranks equal the JAX step on the same batch
    want_loss, want = _jax_step(start, *multiproc.make_batch())
    for got in (single, *ranks):
        np.testing.assert_allclose(got["loss"], want_loss, rtol=multiproc.LOSS_RTOL)
        model.load_state_dict(got["params"])
        flat = flatten(model.params())
        assert flat.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(flat[k].numpy(), v, rtol=0, atol=multiproc.PARAM_ATOL,
                                       err_msg=k)


def test_canary_per_rank_batch_statistics_fail(single):
    """With the hook off (each rank steps without the group), each rank
    normalises with its own half-batch statistics, as plain DDP would: the
    running means leave the one process's."""
    ranks = multiproc.run_ranks(2, "cpu", local_bn=True)
    gap = max(float((r["params"][k] - v).abs().max()) for r in ranks
              for k, v in single["params"].items() if k.endswith("running_mean"))
    assert gap > 10 * multiproc.PARAM_ATOL, gap  # measured 1.2e-3, 60 times the bound
    assert multiproc.compare(ranks, single)["params"] > 1


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_one_rank_group_is_bit_identical(world_of_one, compute_dtype):
    """A step with a one-rank group equals the step without one bit for bit:
    loss, gradients, every param and running statistic; in f32 and on the
    bf16 ``functional_call`` path."""
    noisy, clean = multiproc.make_batch()
    out = []
    for group in (None, world_of_one):
        model = GTCRNMicro.from_params(init_params(torch.Generator().manual_seed(0),
                                                   device="cpu"), device="cpu")
        opt = make_optimizer(model, WarmupCosineConfig(warmup_steps=5, decay_until_step=100,
                                                       max_lr=1e-3), device="cpu")
        step = make_train_step(model, opt, compute_dtype=compute_dtype, device="cpu",
                               group=group)
        losses = [step(noisy, clean) for _ in range(2)]  # the second update has lr > 0
        out.append((losses, model.state_dict(),
                    {n: p.grad for n, p in model.named_parameters()}))
    (l0, s0, g0), (l1, s1, g1) = out
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_replicate_multiprocess_keeps_rank0_bytes(world_of_one):
    tree = {"a": torch.arange(5.0), "b": {"c": torch.ones(2, 3, dtype=torch.bfloat16),
                                          "d": torch.tensor(0.25)}}
    want = {"a": tree["a"].clone(), "c": tree["b"]["c"].clone()}
    assert mesh.replicate_multiprocess(tree, world_of_one) is tree
    assert torch.equal(tree["a"], want["a"]) and torch.equal(tree["b"]["c"], want["c"])


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke")
    make_smoke_data(str(root), n_train=8, n_val=1, seconds=1.0)
    return root


def _train_cfg(root, exp):
    """One epoch of two steps of batch 4 (tests/test_torch_train.py's run at
    half the batch: the second update has a learning rate above 0)."""
    return {
        "network": "gtcrn_micro", "seed": 43,
        "scheduler": {"kwargs": {"warmup_steps": 4, "decay_until_step": 40}},
        "train_dataset": {"noisy_root": f"{root}/train/noisy", "length_seconds": 1.0,
                          "num_data_per_epoch": 8},
        "train_dataloader": {"batch_size": 4, "num_workers": 1},
        "valid_dataset": {"noisy_root": f"{root}/val/noisy", "length_seconds": 1.0,
                          "train": False},
        "valid_dataloader": {"batch_size": 1, "num_workers": 1},
        "trainer": {"epochs": 1, "exp_path": str(exp), "log_every": 1},
    }


def test_torchrun_distributed_run_equals_one_process(smoke_root, tmp_path):
    """``torchrun --nproc_per_node=2 -m ...train.train --distributed`` on
    gloo: one dated run written by rank 0 alone (one metrics line per
    event), and a checkpoint after two steps that equals the one-process
    run's, its params moved by the second update."""
    from gtcrn_micro_tpu_torch.train import train as train_mod

    yaml = pytest.importorskip("yaml")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(_train_cfg(smoke_root, tmp_path / "dp" / "exp")))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         f"--master_port={multiproc.free_port()}", "-m", "gtcrn_micro_tpu_torch.train.train",
         "-C", str(cfg), "--device", "cpu", "--distributed"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    runs = list((tmp_path / "dp").iterdir())
    assert len(runs) == 1, runs
    with open(runs[0] / "logs" / "metrics.jsonl") as f:
        lines = [json.loads(ln) for ln in f]
    assert [m["step"] for m in lines if "train_loss" in m] == [1, 2]
    assert [m["epoch"] for m in lines if "val_loss" in m] == [1]
    got = CheckpointManager(str(runs[0] / "checkpoints")).restore()

    one = train_mod.run(_train_cfg(smoke_root, tmp_path / "one" / "exp"), device="cpu")
    want = CheckpointManager(f"{one}/checkpoints").restore()
    flat = lambda t, p="": ({k2: v2 for k, v in t.items()  # noqa: E731
                             for k2, v2 in flat(v, f"{p}{k}.").items()}
                            if isinstance(t, dict) else {p[:-1]: t})
    g, w = flat(got["params"]), flat(want["params"])
    assert g.keys() == w.keys() and got["step"] == want["step"] == 2
    start = flatten(init_params(torch.Generator().manual_seed(43), device="cpu"))
    assert any(not torch.equal(w[k], start[k]) for k in w if "running" not in k)
    # a bias ahead of a BatchNorm: two Adam steps of lr(1) whose signs are noise
    bias_tol = 2 * warmup_cosine_lr(1, WarmupCosineConfig(warmup_steps=4, decay_until_step=40))
    for k in w:
        np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), rtol=0, err_msg=k,
                                   atol=bias_tol if k.endswith(".b") else multiproc.PARAM_ATOL)
    with open(f"{one}/logs/metrics.jsonl") as f:
        one_lines = [json.loads(ln) for ln in f]
    np.testing.assert_allclose([m["train_loss"] for m in lines if "train_loss" in m],
                               [m["train_loss"] for m in one_lines if "train_loss" in m],
                               rtol=multiproc.LOSS_RTOL)


def test_batch_must_divide_by_the_world(world_of_one, monkeypatch):
    from gtcrn_micro_tpu_torch.train import train as train_mod

    monkeypatch.setattr(train_mod, "init_distributed",
                        lambda device: (0, 3, torch.device("cpu"), world_of_one))
    with pytest.raises(ValueError, match="world size 3"):
        train_mod.run({"train_dataloader": {"batch_size": 8}}, device="cpu", distributed=True)


# -- helpers ---------------------------------------------------------------------


def _jax_script():
    spec = importlib.util.spec_from_file_location("multiproc_dp", ROOT / "scripts" /
                                                  "multiproc_dp.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_shard_batch_multiprocess_gives_the_jax_rows():
    """The JAX script's batch, and its rows per process (pid * per ...)."""
    js = _jax_script()
    (jn, jc), = js._make_batches(1)
    noisy, clean = multiproc.make_batch()
    np.testing.assert_array_equal(noisy, jn)
    np.testing.assert_array_equal(clean, jc)
    for nproc in (1, 2, 4):
        per = js.GLOBAL_BATCH // nproc
        for pid in range(nproc):
            n, c = mesh.shard_batch_multiprocess((noisy, clean), pid, nproc)
            np.testing.assert_array_equal(n, jn[pid * per : (pid + 1) * per])
            np.testing.assert_array_equal(c, jc[pid * per : (pid + 1) * per])
    with pytest.raises(ValueError, match="divide"):
        mesh.shard_batch_multiprocess((noisy,), 0, 3)
    with pytest.raises(ValueError, match="rank"):
        mesh.shard_batch_multiprocess((noisy,), 2, 2)


def test_shard_batch_and_replicate():
    cpu = torch.device("cpu")
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    pieces = mesh.shard_batch([cpu, cpu, cpu], {"x": x, "y": torch.arange(6)})
    assert [p["x"].tolist() for p in pieces] == [x[:2].tolist(), x[2:4].tolist(), x[4:].tolist()]
    assert [p["y"].tolist() for p in pieces] == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError, match="divide"):
        mesh.shard_batch([cpu] * 4, {"x": x})
    reps = mesh.replicate([cpu, cpu], {"w": torch.ones(3)})
    assert len(reps) == 2 and all(torch.equal(r["w"], torch.ones(3)) for r in reps)


def test_make_mesh_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()


# -- sharded serving ---------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    return init_params(torch.Generator().manual_seed(1), device="cpu")


def _backend(kind, params):
    if kind == "layout":
        return LayoutGTCRNMicro(params, device="cpu")
    return GTCRNMicro.from_params(params, device="cpu")


@pytest.mark.parametrize("mode", ["spec", "audio"])
@pytest.mark.parametrize("kind", ["layout", "layered"])
def test_sharded_server_matches_unsharded(params, kind, mode):
    """mesh=[cpu, cpu]: 4 streams per cohort as two shards of 2, against the
    same server unsharded; then admit, release and reset across the shard
    boundary (slot 2 is shard 1's first slot) on both."""
    B, K = 4, 2
    tol = 2e-6 if mode == "spec" else 2e-5
    model = _backend(kind, params)
    srvs = [CohortServer(model, params, batch=B, n_cohorts=K, dtype=torch.float32, mode=mode,
                         mesh=m, device="cpu" if m is None else None)
            for m in (None, ["cpu", "cpu"])]
    assert len(srvs[1]._states[0]) == 2 and srvs[1].backends[0] is srvs[1].backends[1]
    rng = np.random.default_rng(2)

    def interval():
        shape = (B, 257, 1, 2) if mode == "spec" else (B, 256)
        frames = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.3)
                  for _ in range(K)]
        a, b = (s.round_robin(frames) for s in srvs)
        for x, y in zip(a, b):
            assert y.shape == x.shape
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=tol)

    for _ in range(4):
        interval()
    for s in srvs:  # fill cohort 1, free slots 1 and 2, take one back, reset the other
        assert sorted(s.admit(1) for _ in range(B)) == list(range(B))
        with pytest.raises(RuntimeError, match="full"):
            s.admit(1)
        s.release(1, 1)
        s.release(1, 2)
        assert s.admit(1) == 2  # recycled: reset on admission
        s.reset_slot(1, 1)
    sharded = srvs[1]
    for slot in (1, 2):  # shard 0 local 1, shard 1 local 0: zeroed
        shard, local = divmod(slot, 2)
        st = sharded._states[1][shard]
        axis = sharded.backends[shard].batch_axis
        assert all(float(v.select(axis, local).abs().max()) == 0
                   for k, v in st.items() if k != "step")
    assert all(float(v.select(sharded.backends[1].batch_axis, 1).abs().max()) > 0
               for k, v in sharded._states[1][1].items() if k != "step")
    for _ in range(3):
        interval()
    assert srvs[0].frames_served == sharded.frames_served == 14


def test_sharded_fused_backend_needs_params_off_its_device(params):
    """A backend serves the shards on its own device; a fused backend is
    replicated onto another device from the params, which must be given."""
    model = LayoutGTCRNMicro(params, device="cpu")
    assert serve._replica(model, None, torch.device("cpu")) is model
    with pytest.raises(ValueError, match="replicated from params"):
        serve._replica(model, None, torch.device("meta"))
